"""Decoding result type and the repetition gate.

The port's own copy of what it uses from ``whisper_tpu/decoding/result.py``.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional


@dataclasses.dataclass
class DecodingResult:
    tokens: List[int]
    text: str
    avg_logprob: float
    no_speech_prob: float
    temperature: float
    compression_ratio: float
    token_probs: Optional[List[float]] = None


def compression_ratio(text: str) -> float:
    """zlib compressibility of the text: openai's repetition gate."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))
