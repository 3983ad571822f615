"""Synthetic tone-word speech: a closed-loop dataset for the WER harness.

The port's own copy of ``whisper_tpu/utils/synth.py`` (numpy only). Each
word is a distinct pure tone and a transcript is a word sequence, so a small
model trained from scratch (``training/finetune.py``) can be held to a word
error rate on held-out audio through the whole path: GGML write and load,
mel, encoder, decoder, the sliding-window transcribe, the normalizer and the
WER (``cli eval``). No recorded audio is needed.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

SR = 16000
WORD_SEC = 0.30
WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot",
         "golf", "hotel"]


def word_audio(i: int, rng) -> np.ndarray:
    """One word = one pure tone (distinct frequency) + light noise."""
    t = np.arange(int(SR * WORD_SEC)) / SR
    f = 320.0 + 240.0 * i
    x = 0.25 * np.sin(2 * np.pi * f * t)
    x += 0.01 * rng.standard_normal(x.shape)
    ramp = np.minimum(1.0, np.arange(len(x)) / (0.01 * SR))
    return (x * ramp * ramp[::-1]).astype(np.float32)


def make_pair(rng, n_words=(1, 3), words: Sequence[str] = WORDS,
              repeat: int = 1) -> Tuple[np.ndarray, str]:
    """(audio, transcript) with 50 ms silence gaps between tone-words.

    ``repeat`` speaks each chosen word that many times in a row: a
    structured corpus whose continuations are partly predictable from the
    emitted prefix, as real speech is and i.i.d. random words are not.
    Transcripts stay exact."""
    n = int(rng.integers(n_words[0], n_words[1] + 1))
    idx = rng.integers(0, len(words), n)
    if repeat > 1:
        idx = np.repeat(idx, repeat)
    audio = [np.zeros(int(SR * 0.05), np.float32)]
    for i in idx:
        audio.append(word_audio(int(i), rng))
        audio.append(np.zeros(int(SR * 0.05), np.float32))
    return np.concatenate(audio), " ".join(words[int(i)] for i in idx)


def word_tokens(n_vocab: int, words: Sequence[str] = WORDS) -> List[bytes]:
    """Synthetic token table whose ids 1000.. are real ' word' strings, so
    the greedy longest-match tokenizer encodes transcripts as word tokens
    and decode() round-trips them exactly."""
    tokens = [f"<t{i}>".encode() for i in range(n_vocab)]
    tokens[220] = b" "
    for j, w in enumerate(words):
        tokens[1000 + j] = (" " + w).encode()
    return tokens
