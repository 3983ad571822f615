"""Decode attention over int8 K/V (K4) and its plain PyTorch version.

Port of ``whisper_tpu/kernels/cross_attention_int8.py``
(``cross_attention_int8`` -> ``_kernel``), with the numerics of the path the
JAX package runs, ``model.quant.quant_sdpa``: f32 logits scaled per key,
f32 softmax, and the normalised ``p * v_scale`` rounded to bf16 before the
product with int8 V, whatever q's dtype. (The Pallas kernel rounds it to
q's dtype, which differs for an f32 q.) On a CUDA tensor it launches the
kernel in ``csrc/cross_attention_int8.cu``; on a CPU tensor it runs
``quant_sdpa``. There is no other route: a CUDA call that the kernel cannot
take raises. The kernel splits each head's keys across a thread-block
cluster (``cross_attention_int8_plan``); the ranks agree on the softmax's
max and sum through distributed shared memory before any rounding, so the
split leaves ``pv_out``'s numerics as they are.

One kernel serves both decoder sites: cross-attention (``n_past=None``,
every key) and self-attention over the int8 cache (an int ``n_past``: key
``c`` attends query ``t`` iff ``c <= n_past + t``; or a (B,) tensor, each
row at its own position, read by the kernel from device memory).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..model.quant import QuantKV, quant_sdpa
from .decode_attention import causal_mask, check_rows

D_HEAD = 64
ROW_CHOICES = (1, 2, 4, 5, 8)  # query rows a cluster takes (csrc: WHISPER_K4_ROWS)
MAX_RANKS = 8  # blocks a cluster may have (the portable cluster size)
MAX_CHUNK = 1024  # keys a rank may hold (csrc: MAX_CHUNK)
# Keys a rank aims at when the plan chooses the cluster size, for one query
# row (a greedy step) and for more (a prefill, the beam fold: the logits pass
# costs more per key). From the cluster sizes chip_smoke.py times (PERF.md).
KEYS_PER_RANK = 768
KEYS_PER_RANK_ROWS = 384


class K4Plan(NamedTuple):
    """A launch of K4: ``ranks`` blocks in a cluster per (b, h), rank i
    holding keys ``ranges[i] = (start, stop)``, ``chunk`` keys apart."""

    ranks: int
    chunk: int
    ranges: Tuple[Tuple[int, int], ...]


@functools.lru_cache(maxsize=1024)
def cross_attention_int8_plan(c_len: int, tq: int, n_past: Optional[int] = None,
                              ranks: Optional[int] = None) -> K4Plan:
    """How K4 splits one head's keys across a cluster: the keys the call can
    see (all ``c_len`` for cross-attention, up to ``n_past + tq - 1`` under
    the causal mask) cut into ``ranks`` contiguous ranges that start on
    multiples of 4. ``ranks`` defaults to one rank per ``KEYS_PER_RANK`` keys
    (``KEYS_PER_RANK_ROWS`` for more than one query row), at most
    ``MAX_RANKS`` (so a self call over 75 keys takes one block);
    a trailing rank may be short or empty. ``csrc/cross_attention_int8.cu``
    computes each rank's range from ``chunk`` in the same way."""
    visible = c_len if n_past is None else min(c_len, n_past + tq)
    if ranks is None:
        per = KEYS_PER_RANK if tq == 1 else KEYS_PER_RANK_ROWS
        ranks = min(MAX_RANKS, -(-visible // per))
    if not 1 <= ranks <= MAX_RANKS:
        raise ValueError(f"a K4 cluster takes 1 to {MAX_RANKS} ranks, got {ranks}")
    chunk = 4 * -(-visible // (4 * ranks))
    if chunk > MAX_CHUNK:
        raise ValueError(f"cross_attention_int8 takes at most {MAX_RANKS * MAX_CHUNK} keys, "
                         f"got {visible}")
    ranges = tuple((min(i * chunk, visible), min((i + 1) * chunk, visible))
                   for i in range(ranks))
    return K4Plan(ranks, chunk, ranges)


def cross_attention_int8_reference(q, k8, k_scale, v8, v_scale,
                                   n_past=None) -> torch.Tensor:
    """``quant_sdpa`` over (B,H,T,D) q and (B,H,D,C) int8 K/V, causal at
    ``n_past`` (an int: a (T, C) mask; a (B,) tensor: (B, 1, T, C)) or, with
    None, over every key."""
    mask = None
    if n_past is not None:
        mask = causal_mask(n_past, q.shape[-2], k8.shape[-1], q.device)
    return quant_sdpa(q, QuantKV(k8, k_scale), QuantKV(v8, v_scale), mask, q.dtype)


def _rows_per_block(t: int, c: int) -> int:
    """Query rows a cluster takes: the fewest of ``ROW_CHOICES`` that hold
    min(t, 8); raises for more keys than a cluster can hold."""
    if c > MAX_RANKS * MAX_CHUNK:
        raise ValueError(f"cross_attention_int8 takes at most {MAX_RANKS * MAX_CHUNK} keys, "
                         f"got {c}")
    return next(r for r in ROW_CHOICES if r >= min(t, 8))


def _check(q, k8, k_scale, v8, v_scale) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"cross_attention_int8 takes a float32 or bfloat16 q, got {q.dtype}")
    for name, t in (("k8", k8), ("k_scale", k_scale), ("v8", v8), ("v_scale", v_scale)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if k8.dtype != torch.int8 or v8.dtype != torch.int8:
        raise TypeError(f"k8/v8 must be int8, got {k8.dtype}, {v8.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {k_scale.dtype}, {v_scale.dtype}")
    if q.dim() != 4 or q.shape[-1] != D_HEAD or q.shape[2] == 0:
        raise ValueError(f"q must be (B, H, T>0, {D_HEAD}), got {tuple(q.shape)}")
    B, H = q.shape[:2]
    C = k8.shape[-1]
    if k8.shape != (B, H, D_HEAD, C) or v8.shape != k8.shape or C == 0:
        raise ValueError(f"k8/v8 must be ({B}, {H}, {D_HEAD}, C>0), got "
                         f"{tuple(k8.shape)}, {tuple(v8.shape)}")
    if k_scale.shape != (B, H, C) or v_scale.shape != (B, H, C):
        raise ValueError(f"scales must be ({B}, {H}, {C}), got "
                         f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    # Each batch row contiguous; the batch stride is free (a cache layer slice).
    if k8.stride()[1:] != (D_HEAD * C, C, 1) or v8.stride() != k8.stride():
        raise ValueError(f"k8/v8 need strides (any, {D_HEAD * C}, {C}, 1), alike, "
                         f"got {k8.stride()}, {v8.stride()}")
    if k_scale.stride()[1:] != (C, 1) or v_scale.stride() != k_scale.stride():
        raise ValueError(f"scales need strides (any, {C}, 1), alike, got "
                         f"{k_scale.stride()}, {v_scale.stride()}")


@functools.cache
def _entry():
    """The kernel's C entry point, resolved and typed once per process."""
    from .build import load_library

    fn = load_library("cross_attention_int8").whisper_attention_int8
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k8, k_scale, v8, v_scale, n_past: Optional[int], plan: K4Plan,
            rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the kernel over checked CUDA tensors, as ``plan`` splits
    the keys; ``rows`` is a checked per-row n_past (then ``n_past`` is the
    scalar the plan was sized with)."""
    B, H, T, _ = q.shape
    C = k8.shape[-1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _entry()(q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(), v8.data_ptr(),
                       v_scale.data_ptr(), out.data_ptr(), B, H, T, C, k8.stride(0),
                       k_scale.stride(0), -1 if n_past is None else n_past,
                       None if rows is None else rows.data_ptr(),
                       _rows_per_block(T, C), plan.ranks, plan.chunk,
                       int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"cross_attention_int8 kernel launch failed: cudaError {err}")
    cross_attention_int8.launches += 1
    cross_attention_int8.masked_launches += n_past is not None
    cross_attention_int8.ragged_launches += rows is not None
    return out


def cross_attention_int8(q: torch.Tensor, k8: torch.Tensor, k_scale: torch.Tensor,
                         v8: torch.Tensor, v_scale: torch.Tensor,
                         n_past=None) -> torch.Tensor:
    """softmax((q · k8) · k_scale) · (v8 · v_scale) over (B,H,T,64) q and
    kv-major (B,H,64,C) int8 K/V with (B,H,C) f32 scales; the result has q's
    dtype. ``n_past`` None attends every key (cross-attention); an int, or a
    (B,) int32 tensor on q's device with each row's own position (the
    engine's slots, read by the kernel in device memory), is the causal
    limit of self-attention. On the card the keys are split as
    ``cross_attention_int8_plan`` says, over the whole cache for a tensor.
    ``cross_attention_int8.launches`` counts kernel launches,
    ``.masked_launches`` those with an ``n_past`` (self-attention) and
    ``.ragged_launches`` those with a tensor ``n_past``."""
    if q.device.type == "cpu":
        return cross_attention_int8_reference(q, k8, k_scale, v8, v_scale, n_past)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention_int8 runs on cpu or cuda, not {q.device}")
    _check(q, k8, k_scale, v8, v_scale)
    C, T = k8.shape[-1], q.shape[2]
    rows = None
    if isinstance(n_past, torch.Tensor):
        check_rows(n_past, q, "cross_attention_int8")
        rows, n_past = n_past, max(0, C - T)
    elif n_past is not None and n_past < 0:
        raise ValueError(f"n_past must be >= 0, got {n_past}")
    plan = cross_attention_int8_plan(C, T, n_past)
    return _launch(q, k8, k_scale, v8, v_scale, n_past, plan, rows)


cross_attention_int8.launches = 0
cross_attention_int8.masked_launches = 0
cross_attention_int8.ragged_launches = 0
