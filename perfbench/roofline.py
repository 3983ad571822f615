"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit) and the least time a piece of work can take on it."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12   # FLOP/s, bf16 and fp16 tensor cores
PEAK_BYTES = 3.35e12       # B/s, HBM3


def bound_s(flops: float, bytes_moved: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The larger of the operations over the peak rate and the bytes over
    the memory bandwidth, in seconds."""
    return max(flops / peak_flops, bytes_moved / PEAK_BYTES)


def share(bound: float, measured: float):
    """A roofline share in percent, or None where nothing was measured."""
    if measured <= 0 or bound <= 0:
        return None
    return 100.0 * bound / measured
