"""Decode-step self-attention over the float KV cache (K5) and its plain version.

Port of ``whisper_tpu/kernels/decode_attention.py`` (``cached_attention`` ->
``_cached_attn_kernel``), with the numerics of the path the JAX package
runs at that site, ``model/decoder._kvmajor_sdpa``: f32 scores times
D^-0.5, -1e30 on masked keys, f32 softmax, and the normalised probabilities
rounded to the cache's dtype before the PV sum (the Pallas kernel keeps them
in f32). The kernel reads one layer of the port's batch-leading
(B, L, H, D, C) cache in place, through its batch stride; it needs neither
the TPU kernel's layer-leading layout nor its 128-padded context.

On a CUDA tensor ``cached_attention`` launches ``csrc/decode_attention.cu``;
on a CPU tensor it runs ``cached_attention_reference``. There is no other
route: a CUDA call that the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .ops import NEG

D_HEAD = 64
_SMEM_LIMIT = 200 * 1024  # shared memory a block may take, of the 227 KB
_FLOATS = (torch.float32, torch.bfloat16)


def _kvmajor_sdpa(q, k, v, mask: Optional[torch.Tensor], scale: float):
    """softmax(q kᵀ * scale, masked) v with f32 scores and softmax.

    q (B,H,T,D) head-split; k/v (B,H,D,C) kv-major; mask bool (T,C)
    broadcastable, True = attend, or None for all keys. The normalised
    probabilities round to v's dtype; the result has q's dtype."""
    logits = torch.matmul(q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float().transpose(-1, -2)).to(q.dtype)


def causal_mask(n_past: int, t: int, c: int, device) -> torch.Tensor:
    """(T, C) bool: key ``c`` is seen by query ``t`` iff c <= n_past + t."""
    key_pos = torch.arange(c, device=device)[None, :]
    return key_pos <= n_past + torch.arange(t, device=device)[:, None]


def cached_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               n_past: int) -> torch.Tensor:
    """``_kvmajor_sdpa`` over (B,H,T,D) q and one (B,H,D,C) cache layer,
    with the causal mask at ``n_past``."""
    mask = causal_mask(n_past, q.shape[-2], k.shape[-1], q.device)
    return _kvmajor_sdpa(q, k, v, mask, q.shape[-1] ** -0.5)


def _rows_per_block(t: int, c: int) -> int:
    rows = 1
    while rows < min(t, 8):
        rows *= 2
    while rows > 1 and 4 * rows * (D_HEAD + c) > _SMEM_LIMIT:
        rows //= 2
    if 4 * rows * (D_HEAD + c) > _SMEM_LIMIT:
        raise ValueError(f"cached_attention takes at most {_SMEM_LIMIT // 4 - D_HEAD} "
                         f"positions, got {c}")
    return rows


def _check(q, k, v) -> None:
    if q.dtype not in _FLOATS or k.dtype not in _FLOATS:
        raise TypeError(f"cached_attention takes float32 or bfloat16, got q {q.dtype}, "
                        f"cache {k.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if v.dtype != k.dtype:
        raise TypeError(f"k is {k.dtype}, v is {v.dtype}")
    if q.dim() != 4 or q.shape[-1] != D_HEAD or q.shape[2] == 0:
        raise ValueError(f"q must be (B, H, T>0, {D_HEAD}), got {tuple(q.shape)}")
    B, H = q.shape[:2]
    C = k.shape[-1]
    if k.shape != (B, H, D_HEAD, C) or v.shape != k.shape or C == 0:
        raise ValueError(f"k/v must be ({B}, {H}, {D_HEAD}, C>0), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    # Each batch row contiguous; the batch stride is free (a cache layer slice).
    if k.stride()[1:] != (D_HEAD * C, C, 1) or v.stride() != k.stride():
        raise ValueError(f"k/v need strides (any, {D_HEAD * C}, {C}, 1), alike, "
                         f"got {k.stride()}, {v.stride()}")


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_past: int) -> torch.Tensor:
    """softmax(q kᵀ · D^-0.5, causal at ``n_past``) v over (B,H,T,64) q and
    one kv-major (B,H,64,C) layer of the float cache (f32 or bf16, the batch
    stride free); the result has q's dtype. ``cached_attention.launches``
    counts kernel launches."""
    if q.device.type == "cpu":
        return cached_attention_reference(q, k, v, n_past)
    if q.device.type != "cuda":
        raise ValueError(f"cached_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    if n_past < 0:
        raise ValueError(f"n_past must be >= 0, got {n_past}")
    from .build import load_library

    fn = load_library("decode_attention").whisper_cached_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                                                 ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, H, T, _ = q.shape
    C = k.shape[-1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, T, C,
                 k.stride(0), n_past, D_HEAD ** -0.5, _rows_per_block(T, C),
                 int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"cached_attention kernel launch failed: cudaError {err}")
    cached_attention.launches += 1
    return out


cached_attention.launches = 0
