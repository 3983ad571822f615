"""Token-level timestamps (whisper.cpp's experimental algorithm).

The port's own copy of ``whisper_tpu/pipeline/timestamps.py``, numpy only:

  1. per-sample signal energy (moving average of |PCM|);
  2. within each segment, timestamp tokens act as hard anchors; text tokens
     between anchors get the span distributed proportionally to their "voice
     length" (a per-character weight, whisper.cpp's token_vlen);
  3. token spans are tightened against the energy profile (leading and
     trailing low-energy audio skipped).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..config import SAMPLE_RATE
from ..decoding.result import Segment, TokenData
from ..io.vocab import WhisperVocab


def signal_energy(audio: np.ndarray, window: int = 160) -> np.ndarray:
    """Moving-average |PCM|."""
    a = np.abs(audio.astype(np.float32))
    kernel = np.ones(2 * window + 1, dtype=np.float32) / (2 * window + 1)
    return np.convolve(a, kernel, mode="same")


def token_voice_length(token_bytes: bytes) -> float:
    """whisper.cpp's voice-length heuristic: rough speaking duration weight."""
    try:
        text = token_bytes.decode("utf-8")
    except UnicodeDecodeError:
        return float(len(token_bytes))
    res = 0.0
    for ch in text:
        if ch == " ":
            res += 0.01
        elif ch in ".,!?":
            res += 0.4  # punctuation pause
        elif ch.isalpha() or ch.isdigit():
            res += 1.0
        else:
            res += 0.5
    return max(res, 0.01)


def compute_token_timestamps(
    segment: Segment,
    vocab: WhisperVocab,
    energy: Optional[np.ndarray] = None,
    energy_threshold: float = 0.15,
) -> List[TokenData]:
    """Fill t0/t1 for every token of a segment."""
    tokens = segment.tokens
    n = len(tokens)
    if n == 0:
        return []

    # Anchor times: timestamp tokens pin their position; segment bounds pin
    # the ends.
    times = np.full(n + 1, np.nan)
    times[0] = segment.t0
    times[n] = segment.t1
    for i, t in enumerate(tokens):
        if vocab.is_timestamp(t):
            anchor = segment.seek * 0.01 + vocab.timestamp_to_seconds(t)
            times[i] = anchor
            times[i + 1] = anchor

    # Distribute un-anchored spans by voice length.
    vlens = np.array(
        [
            0.0 if vocab.is_timestamp(t) or t >= vocab.token_eot
            else token_voice_length(vocab.token_bytes(t))
            for t in tokens
        ]
    )
    i = 0
    while i <= n:
        if np.isnan(times[i]):
            j0 = i - 1
            j1 = i
            while j1 <= n and np.isnan(times[j1]):
                j1 += 1
            left_t = times[j0]
            right_t = times[j1] if j1 <= n else segment.t1
            w = vlens[j0:j1]
            total = w.sum()
            acc = left_t
            span = max(right_t - left_t, 0.0)
            for k in range(j0, j1):
                frac = (vlens[k] / total) if total > 0 else 1.0 / max(j1 - j0, 1)
                acc = acc + frac * span
                times[k + 1] = acc
            i = j1
        else:
            i += 1

    out = []
    for i, t in enumerate(tokens):
        t0, t1 = float(times[i]), float(times[i + 1])
        if energy is not None and not vocab.is_timestamp(t):
            t0, t1 = _tighten(t0, t1, energy, energy_threshold)
        out.append(TokenData(id=int(t), t0=round(t0, 3), t1=round(t1, 3)))
    return out


def _tighten(t0: float, t1: float, energy: np.ndarray, threshold: float):
    """Shrink a token span to where the signal actually has energy."""
    s0 = int(t0 * SAMPLE_RATE)
    s1 = int(t1 * SAMPLE_RATE)
    s0 = max(0, min(s0, len(energy) - 1))
    s1 = max(s0 + 1, min(s1, len(energy)))
    window = energy[s0:s1]
    if window.size == 0:
        return t0, t1
    thr = threshold * float(window.max())
    above = np.nonzero(window >= thr)[0]
    if above.size == 0:
        return t0, t1
    return s0 / SAMPLE_RATE + above[0] / SAMPLE_RATE, s0 / SAMPLE_RATE + (above[-1] + 1) / SAMPLE_RATE


def add_token_timestamps(
    segments: Sequence[Segment],
    vocab: WhisperVocab,
    audio: Optional[np.ndarray] = None,
) -> None:
    """Annotate segments in place with per-token timestamps."""
    energy = signal_energy(audio) if audio is not None else None
    for seg in segments:
        seg.token_data = compute_token_timestamps(seg, vocab, energy)
