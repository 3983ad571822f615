"""Decoding result types and the repetition gate.

The port's own copy of ``whisper_tpu/decoding/result.py``.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional


@dataclasses.dataclass
class TokenData:
    """Per-token data: probability and token-level times."""

    id: int
    p: float = 0.0       # probability of the token
    t0: float = -1.0     # start time (s), token-level (if computed)
    t1: float = -1.0     # end time (s)


@dataclasses.dataclass
class DecodingResult:
    tokens: List[int]
    text: str
    avg_logprob: float
    no_speech_prob: float
    temperature: float
    compression_ratio: float
    token_probs: Optional[List[float]] = None


@dataclasses.dataclass
class Segment:
    """One output segment of ``pipeline.transcribe``."""

    id: int
    seek: int            # mel-frame offset of the window this came from
    t0: float            # start time in seconds
    t1: float            # end time in seconds
    text: str
    tokens: List[int]
    avg_logprob: float
    no_speech_prob: float
    temperature: float
    compression_ratio: float
    token_data: Optional[List[TokenData]] = None
    # word-level timestamps (cross-attention DTW, pipeline/word_timing.py)
    words: Optional[List[dict]] = None


def compression_ratio(text: str) -> float:
    """zlib compressibility of the text: openai's repetition gate."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))
