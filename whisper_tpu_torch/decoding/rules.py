"""Logit filters: suppression and timestamp rules (openai-whisper semantics).

The port's own copy of ``whisper_tpu/decoding/rules.py``: SuppressBlank,
SuppressTokens and ApplyTimestampRules, as openai-whisper's ``decoding.py``
defines them. The host decode loop (``decoding.task.DecodingTask.run``)
runs them on host numpy logits of shape (n_seq, n_vocab) between device
steps; the device loops apply the same rules vectorised on the card
(``decoding.device_loop._apply_rules_device``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..io.vocab import WhisperVocab

NEG_INF = -np.inf


def build_suppress_list(
    vocab: WhisperVocab,
    suppress_tokens: Optional[Sequence[int]] = (-1,),
) -> List[int]:
    """Expand the suppress-token spec: -1 -> non-speech tokens; always add the
    special tokens that must never be sampled."""
    out: List[int] = []
    if suppress_tokens:
        for t in suppress_tokens:
            if t == -1:
                out.extend(vocab.non_speech_tokens())
            elif t >= 0:
                out.append(t)
    out.extend(
        [
            vocab.token_transcribe,
            vocab.token_translate,
            vocab.token_sot,
            vocab.token_prev,
            vocab.token_solm,
            vocab.token_nosp,
        ]
    )
    return sorted(set(out))


class SuppressTokens:
    def __init__(self, suppress: Sequence[int]):
        self.suppress = list(suppress)

    def __call__(self, logits: np.ndarray, tokens: np.ndarray) -> None:
        logits[:, self.suppress] = NEG_INF


class SuppressBlank:
    """At the first sampled position, forbid blank (' ') and EOT."""

    def __init__(self, vocab: WhisperVocab, sample_begin: int):
        self.sample_begin = sample_begin
        blank = vocab.token_to_id.get(b" ")
        self.suppress = [t for t in (blank, vocab.token_eot) if t is not None]

    def __call__(self, logits: np.ndarray, tokens: np.ndarray) -> None:
        if tokens.shape[1] == self.sample_begin:
            logits[:, self.suppress] = NEG_INF


class ApplyTimestampRules:
    """openai's timestamp grammar:

    * <|notimestamps|> is never sampled;
    * timestamps come in pairs (except directly before EOT): if the last
      token was a timestamp and the one before was too, timestamps are
      masked; if the last was a timestamp but the penultimate was not, text
      tokens are masked;
    * timestamps are non-decreasing within a segment;
    * the first sampled token must be a timestamp, at most max_initial;
    * if the total timestamp probability mass beats the best text token,
      force a timestamp.
    """

    def __init__(
        self,
        vocab: WhisperVocab,
        sample_begin: int,
        max_initial_timestamp_index: Optional[int] = 50,  # 1.0 s / 0.02
    ):
        self.vocab = vocab
        self.sample_begin = sample_begin
        self.max_initial_timestamp_index = max_initial_timestamp_index

    def __call__(self, logits: np.ndarray, tokens: np.ndarray) -> None:
        v = self.vocab
        beg = v.token_beg
        logits[:, v.token_not] = NEG_INF

        for k in range(tokens.shape[0]):
            sampled = tokens[k, self.sample_begin :]
            last_was = sampled.size >= 1 and sampled[-1] >= beg
            penultimate_was = sampled.size < 2 or sampled[-2] >= beg
            if last_was:
                if penultimate_was:  # pair complete: no more timestamps
                    logits[k, beg:] = NEG_INF
                else:  # lone timestamp: must pair up (no text)
                    logits[k, : v.token_eot] = NEG_INF
            ts = sampled[sampled >= beg]
            if ts.size > 0:
                # non-decreasing; strictly increasing once the pair closed
                last_allowed = ts[-1] if last_was and not penultimate_was else ts[-1] + 1
                logits[k, beg:last_allowed] = NEG_INF

        if tokens.shape[1] == self.sample_begin:
            logits[:, :beg] = NEG_INF  # first token must be a timestamp
            if self.max_initial_timestamp_index is not None:
                last_allowed = beg + self.max_initial_timestamp_index
                logits[:, last_allowed + 1 :] = NEG_INF

        # If P(timestamp) > max P(text), force a timestamp.
        logprobs = log_softmax(logits)
        for k in range(tokens.shape[0]):
            ts_logprob = np.logaddexp.reduce(logprobs[k, beg:])
            max_text = logprobs[k, :beg].max()
            if ts_logprob > max_text:
                logits[k, :beg] = NEG_INF


def log_softmax(logits: np.ndarray) -> np.ndarray:
    x = logits - logits.max(axis=-1, keepdims=True)
    with np.errstate(divide="ignore"):  # exp(-inf) rows are fine
        return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))
