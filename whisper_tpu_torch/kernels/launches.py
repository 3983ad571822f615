"""The kernel wrappers' launch counters as one table.

Each wrapper counts its own launches in attributes of its function (K1 by
kernel: bf16, f32, K1b; the K1c backward; K2/K3; K4, with self alone and
with a per-row ``n_past``; K5, with a per-row ``n_past``; K6; K7).
``kernel_launches`` reads them all; ``add_launches`` adds to them, which is
how a CUDA graph's replay counts the kernels its capture recorded (the
wrappers' Python runs once, at the capture, and not at a replay).
"""

from __future__ import annotations

from typing import Dict

from . import beam_gather, fused_quant
from .cross_attention_int8 import cross_attention_int8
from .decode_attention import cached_attention
from .flash_attention import flash_attention, flash_sdpa

COUNTERS = {
    "k1": (flash_attention, "launches"), "k1_f32": (flash_attention, "f32_launches"),
    "k1b": (flash_attention, "int8_launches"), "k1c_bwd": (flash_sdpa, "bwd_launches"),
    "act": (fused_quant.act_quant, "launches"), "ln": (fused_quant.ln_quant, "launches"),
    "gelu": (fused_quant.gelu_quant, "launches"), "k4": (cross_attention_int8, "launches"),
    "k4_self": (cross_attention_int8, "masked_launches"),
    "k4_ragged": (cross_attention_int8, "ragged_launches"),
    "k5": (cached_attention, "launches"), "k5_ragged": (cached_attention, "ragged_launches"),
    "k6": (beam_gather.permute_rows_multi, "launches"),
    "k7": (beam_gather.cow_copy_rows, "launches"),
}


def kernel_launches() -> Dict[str, int]:
    """Every kernel wrapper's launch count so far, by the names of
    ``COUNTERS``."""
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` (counts by the names of ``COUNTERS``) to the counters."""
    for name, n in delta.items():
        fn, attr = COUNTERS[name]
        setattr(fn, attr, getattr(fn, attr) + n)
