"""Decode attention over int8 K/V (K4) and its plain PyTorch version.

Port of ``whisper_tpu/kernels/cross_attention_int8.py``
(``cross_attention_int8`` -> ``_kernel``), with the numerics of the path the
JAX package runs, ``model.quant.quant_sdpa``: f32 logits scaled per key,
f32 softmax, and the normalised ``p * v_scale`` rounded to bf16 before the
product with int8 V, whatever q's dtype. (The Pallas kernel rounds it to
q's dtype, which differs for an f32 q.) On a CUDA tensor it launches the
kernel in ``csrc/cross_attention_int8.cu``; on a CPU tensor it runs
``quant_sdpa``. There is no other route: a CUDA call that the kernel cannot
take raises.

One kernel serves both decoder sites: cross-attention (``n_past=None``,
every key) and self-attention over the int8 cache (an int ``n_past``: key
``c`` attends query ``t`` iff ``c <= n_past + t``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..model.quant import QuantKV, quant_sdpa

D_HEAD = 64
_SMEM_LIMIT = 200 * 1024  # shared memory a block may take, of the 227 KB


def cross_attention_int8_reference(q, k8, k_scale, v8, v_scale,
                                   n_past: Optional[int] = None) -> torch.Tensor:
    """``quant_sdpa`` over (B,H,T,D) q and (B,H,D,C) int8 K/V."""
    mask = None
    if n_past is not None:
        C, T = k8.shape[-1], q.shape[-2]
        key_pos = torch.arange(C, device=q.device)[None, :]
        mask = key_pos <= n_past + torch.arange(T, device=q.device)[:, None]
    return quant_sdpa(q, QuantKV(k8, k_scale), QuantKV(v8, v_scale), mask, q.dtype)


def _rows_per_block(t: int, c: int) -> int:
    rows = 1
    while rows < min(t, 8):
        rows *= 2
    while rows > 1 and 4 * rows * (D_HEAD + c) > _SMEM_LIMIT:
        rows //= 2
    if 4 * rows * (D_HEAD + c) > _SMEM_LIMIT:
        raise ValueError(f"cross_attention_int8 takes at most "
                         f"{_SMEM_LIMIT // 4 - D_HEAD} keys, got {c}")
    return rows


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


def cross_attention_int8(q: torch.Tensor, k8: torch.Tensor, k_scale: torch.Tensor,
                         v8: torch.Tensor, v_scale: torch.Tensor,
                         n_past: Optional[int] = None) -> torch.Tensor:
    """softmax((q · k8) · k_scale) · (v8 · v_scale) over (B,H,T,64) q and
    kv-major (B,H,64,C) int8 K/V with (B,H,C) f32 scales; the result has q's
    dtype. ``cross_attention_int8.launches`` counts kernel launches, and
    ``.masked_launches`` those with an ``n_past`` (self-attention)."""
    if q.device.type == "cpu":
        return cross_attention_int8_reference(q, k8, k_scale, v8, v_scale, n_past)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention_int8 runs on cpu or cuda, not {q.device}")
    _check(q, k8, k_scale, v8, v_scale)
    if n_past is not None and n_past < 0:
        raise ValueError(f"n_past must be >= 0, got {n_past}")
    from .build import load_library

    fn = load_library("cross_attention_int8").whisper_attention_int8
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, H, T, _ = q.shape
    C = k8.shape[-1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(), v8.data_ptr(),
                 v_scale.data_ptr(), out.data_ptr(), B, H, T, C, k8.stride(0),
                 k_scale.stride(0), -1 if n_past is None else n_past,
                 _rows_per_block(T, C), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"cross_attention_int8 kernel launch failed: cudaError {err}")
    cross_attention_int8.launches += 1
    cross_attention_int8.masked_launches += n_past is not None
    return out


cross_attention_int8.launches = 0
cross_attention_int8.masked_launches = 0
