"""Whisper vocabulary: token tables, special tokens, detokenization.

The port's own copy of what it calls in ``whisper_tpu/io/vocab.py``. The
special-token block is computed positionally from the vocab size, which
gives the ids of tiny.en, of the multilingual v1/v2 models and of
large-v3's 51866-token vocab. GGML files store each token as raw bytes;
text is the concatenation of a sequence's token bytes, decoded as UTF-8.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# The 99 Whisper languages in training-data order; language token for index i
# is ``sot + 1 + i``. large-v3 appends "yue" as the 100th.
WHISPER_LANGUAGES: Tuple[str, ...] = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su",
)
WHISPER_LANGUAGES_V3 = WHISPER_LANGUAGES + ("yue",)


@dataclasses.dataclass
class WhisperVocab:
    """Token table and special ids."""

    n_vocab: int
    # id -> raw token bytes as stored in the GGML file
    id_to_token: Dict[int, bytes]
    token_to_id: Dict[bytes, int]

    token_eot: int
    token_sot: int
    token_translate: int
    token_transcribe: int
    token_solm: int  # <|startoflm|>
    token_prev: int  # <|startofprev|>
    token_nosp: int  # <|nospeech|>
    token_not: int  # <|notimestamps|>
    token_beg: int  # first timestamp token <|0.00|>

    languages: Tuple[str, ...]

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865

    def language_token(self, lang: str) -> int:
        try:
            return self.token_sot + 1 + self.languages.index(lang)
        except ValueError:
            raise KeyError(f"unknown language {lang!r}") from None

    def language_of_token(self, token: int) -> str:
        idx = token - self.token_sot - 1
        if not 0 <= idx < len(self.languages):
            raise KeyError(f"token {token} is not a language token")
        return self.languages[idx]

    @property
    def all_language_tokens(self) -> List[int]:
        return [self.token_sot + 1 + i for i in range(len(self.languages))]

    def is_timestamp(self, token: int) -> bool:
        return token >= self.token_beg

    def timestamp_to_seconds(self, token: int) -> float:
        return (token - self.token_beg) * 0.02

    def token_bytes(self, token: int) -> bytes:
        return self.id_to_token.get(token, b"")

    def decode(self, tokens, strip_special: bool = True) -> str:
        """Concatenate token bytes -> UTF-8 text (whisper.cpp print semantics)."""
        parts = []
        for t in tokens:
            t = int(t)
            if strip_special and t >= self.token_eot:
                continue
            parts.append(self.id_to_token.get(t, b""))
        return b"".join(parts).decode("utf-8", errors="replace")

    @property
    def bpe(self):
        """Exact GPT-2 BPE encoder, rebuilt lazily from the id table
        (``io.bpe``). ``bpe.valid`` is False for non-BPE vocabs (synthetic
        fixtures)."""
        if getattr(self, "_bpe", None) is None:
            from .bpe import ByteBPE

            self._bpe = ByteBPE(self.id_to_token, self.token_eot)
        return self._bpe

    def encode(self, text: str) -> List[int]:
        """Text -> token ids: exact BPE when the vocab is a real byte-level
        BPE table, greedy longest-match otherwise (whisper.cpp's approach,
        adequate only for synthetic vocabs)."""
        if self.bpe.valid:
            return self.bpe.encode(text)
        data = text.encode("utf-8")
        tokens: List[int] = []
        i = 0
        max_len = max((len(t) for t in self.token_to_id), default=1)
        while i < len(data):
            match = None
            for ln in range(min(max_len, len(data) - i), 0, -1):
                tid = self.token_to_id.get(data[i: i + ln])
                if tid is not None and tid < self.token_eot:
                    match = (tid, ln)
                    break
            if match is None:
                i += 1  # an unencodable byte is skipped (openai never meets one)
                continue
            tokens.append(match[0])
            i += match[1]
        return tokens

    def non_speech_tokens(self) -> List[int]:
        """Tokens suppressed by openai-whisper's SuppressTokens(-1): symbols,
        music/misc markers, never produced in transcription output.

        With a real BPE vocab this reproduces openai's computation exactly:
        single-token symbol encodings (bare + space-prefixed) plus the FIRST
        BPE piece of each miscellaneous music symbol even when multi-token.
        """
        cached = getattr(self, "_non_speech", None)
        if cached is not None:
            return cached
        if self.bpe.valid:
            symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
            symbols += (
                '<< >> <<< >>> -- --- -( -[ (\' (" (( )) ((( ))) [[ ]] {{ }} '
                "♪♪ ♪♪♪".split()
            )
            miscellaneous = set("♩♪♫♬♭♮♯")
            result = set()
            for s in (" -", " '"):
                ids = self.bpe.encode(s)
                if ids:
                    result.add(ids[0])
            for symbol in symbols + list(miscellaneous):
                for ids in (self.bpe.encode(symbol), self.bpe.encode(" " + symbol)):
                    if len(ids) == 1 or symbol in miscellaneous:
                        if ids:
                            result.add(ids[0])
            self._non_speech = sorted(result)
            return self._non_speech
        self._non_speech = self._non_speech_bytes()
        return self._non_speech

    def _non_speech_bytes(self) -> List[int]:
        """Exact-byte fallback for non-BPE (synthetic) vocabs."""
        symbols = (
            [bytes([c]) for c in b'"#()*+/:;<=>@[\\]^_`{|}~']
            + [s.encode() for s in "「」『』"]  # CJK quotes (single gpt2 tokens)
            + [
                b"<<", b">>", b"<<<", b">>>", b"--", b"---", b"-(", b"-[", b"('",
                b'("', b"((", b"))", b"(((", b")))", b"[[", b"]]", b"{{", b"}}",
                "♪♪".encode(), "♪♪♪".encode(),
            ]
            # openai's miscellaneous music/accidental set
            + [s.encode() for s in "♩♪♫♬♭♮♯"]
        )
        candidates = set()
        for s in symbols:
            candidates.add(s)
            candidates.add(b" " + s)
        result = set()
        # "-" and "'" only suppressed with leading space
        for s in (b" -", b" '"):
            tid = self.token_to_id.get(s)
            if tid is not None:
                result.add(tid)
        for s in candidates:
            tid = self.token_to_id.get(s)
            if tid is not None:
                result.add(tid)
        return sorted(result)


def build_special_ids(n_vocab: int) -> Dict[str, int]:
    """Positional layout of Whisper's special-token block.

    English (51864): eot=50256, sot=50257, prev=50360, not=50362, beg=50363.
    Multilingual (51865): each of those +1. large-v3 (51866): langs grow to 100.
    """
    eot = 50256 if n_vocab == 51864 else 50257
    num_langs = 100 if n_vocab >= 51866 else 99
    sot = eot + 1
    translate = sot + 1 + num_langs
    transcribe = translate + 1
    solm = transcribe + 1
    prev = solm + 1
    nosp = prev + 1
    not_ = nosp + 1
    beg = not_ + 1
    return dict(
        token_eot=eot,
        token_sot=sot,
        token_translate=translate,
        token_transcribe=transcribe,
        token_solm=solm,
        token_prev=prev,
        token_nosp=nosp,
        token_not=not_,
        token_beg=beg,
        num_languages=num_langs,
    )


def device_special_ids(n_vocab: int) -> Tuple[int, int, int, int]:
    """(eot, beg, not_, nosp) for the device decode loops, derived from
    ``build_special_ids`` so they cannot drift from the host rules."""
    ids = build_special_ids(n_vocab)
    return (ids["token_eot"], ids["token_beg"],
            ids["token_not"], ids["token_nosp"])


def make_vocab(n_vocab_header: int, tokens: List[bytes], n_vocab_loaded: int) -> WhisperVocab:
    """Build the vocab from GGML file contents.

    ``n_vocab_header`` is hparams.n_vocab; ``tokens`` are the ``n_vocab_loaded``
    byte strings actually present in the file. Missing ids get synthesized
    names, as whisper.cpp names them.
    """
    ids = build_special_ids(n_vocab_header)
    langs = WHISPER_LANGUAGES_V3 if ids["num_languages"] == 100 else WHISPER_LANGUAGES

    id_to_token: Dict[int, bytes] = {}
    token_to_id: Dict[bytes, int] = {}
    for i, tok in enumerate(tokens):
        id_to_token[i] = tok
        token_to_id[tok] = i

    for i in range(n_vocab_loaded, n_vocab_header):
        if i > ids["token_beg"]:
            word = f"[_TT_{i - ids['token_beg']}]"
        elif i == ids["token_eot"]:
            word = "[_EOT_]"
        elif i == ids["token_sot"]:
            word = "[_SOT_]"
        elif i == ids["token_prev"]:
            word = "[_PREV_]"
        elif i == ids["token_not"]:
            word = "[_NOT_]"
        elif i == ids["token_beg"]:
            word = "[_BEG_]"
        else:
            word = f"[_extra_token_{i}]"
        b = word.encode()
        id_to_token[i] = b
        token_to_id[b] = i

    return WhisperVocab(
        n_vocab=n_vocab_header,
        id_to_token=id_to_token,
        token_to_id=token_to_id,
        token_eot=ids["token_eot"],
        token_sot=ids["token_sot"],
        token_translate=ids["token_translate"],
        token_transcribe=ids["token_transcribe"],
        token_solm=ids["token_solm"],
        token_prev=ids["token_prev"],
        token_nosp=ids["token_nosp"],
        token_not=ids["token_not"],
        token_beg=ids["token_beg"],
        languages=langs,
    )
