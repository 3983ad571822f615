"""Whisper's special tokens and languages, laid out from the vocabulary size
as openai's tokenizer lays them out (51864: English only; 51865: 99
languages; 51866: large-v3's 100)."""

LANGUAGES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
)


class Special:
    def __init__(self, n_vocab: int):
        self.n_vocab = n_vocab
        self.multilingual = n_vocab >= 51865
        self.eot = 50256 if n_vocab == 51864 else 50257
        self.n_langs = 100 if n_vocab >= 51866 else 99
        self.sot = self.eot + 1
        self.translate = self.sot + 1 + self.n_langs
        self.transcribe = self.translate + 1
        self.solm = self.transcribe + 1
        self.prev = self.solm + 1
        self.nosp = self.prev + 1
        self.no_timestamps = self.nosp + 1
        self.beg = self.no_timestamps + 1
        self.languages = LANGUAGES[: self.n_langs]

    def language_token(self, lang: str) -> int:
        return self.sot + 1 + self.languages.index(lang)

    def sot_sequence(self, lang: str) -> list:
        if not self.multilingual:
            return [self.sot]
        return [self.sot, self.language_token(lang), self.transcribe]

    def never_sampled(self) -> list:
        """openai's SuppressTokens(-1) over a ``tok<i>`` vocabulary: no token
        spells a non-speech symbol, so only the special tokens that are never
        sampled remain."""
        return [self.transcribe, self.translate, self.sot, self.prev, self.solm, self.nosp]
