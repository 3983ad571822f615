"""Encoder self-attention kernel (K1), its int8-score variant (K1b), the
differentiable wrapper (K1c), and their plain PyTorch versions.

``flash_attention`` is the port of ``whisper_tpu/kernels/flash_attention.py``
(``flash_attention`` -> ``_attn_kernel``). On a CUDA tensor it launches the
hand-written kernel ``csrc/flash_attention.cu`` (see the note there: for
bf16, TMA loads of 128-key K/V tiles into a ring of shared-memory stages and
``wgmma`` products with an online f32 softmax in registers, where the TPU
kernel held one head's whole K/V and score tile in VMEM); on a CPU tensor it
runs ``flash_attention_reference``. There is no other route: a CUDA call
that the kernel cannot take raises. ``attention_tile_plan`` states the bf16
kernel's tile plan, so that the CPU tests can check it.

``flash_attention(..., qk_int8=True)`` is the TPU kernel's ``qk_int8``
option (K1b): Q and K quantized per row to int8 and an exact int32 score
dot; its plain version is ``flash_attention_int8_reference``.

``flash_sdpa`` is JAX's ``flash_sdpa`` custom VJP (K1c) as a
``torch.autograd.Function``: the forward is ``flash_attention`` (the kernel
on the card), the backward the closed form in plain torch, as JAX's
backward is XLA einsums. ``flash_attention`` itself has no backward: on a
CUDA tensor it raises when a gradient is asked of it, so gradients reach
K1 only through ``flash_sdpa``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

NEG = -1e30
# f32(1 / 127): XLA compiles the TPU kernel's ``max(|x|, 1e-6) / 127.0`` into
# a product with this constant (the division by the scale stays a division).
INV_127 = float(np.float32(1.0 / 127.0))
D_HEAD = 64  # every Whisper size: 384/6 ... 1280/20
BLOCK_Q, BLOCK_K = 192, 128  # the bf16 kernel's query rows per block, keys per tile


def attention_tile_plan(tq: int, tk: int, causal: bool) -> list:
    """The bf16 kernel's plan for one head: per block, ``(q0, q1,
    key_tiles, masked)`` with query rows ``q0 .. q1 - 1``, the key tiles it
    loads (``range(key_tiles)``, tile n holding keys ``n * BLOCK_K ..``) and
    the tiles among them that take the per-element mask: those holding a
    key ``>= tk`` (TMA fills them with zeros) or, under ``causal``, a key
    past the block's first row. Under ``causal`` the tiles wholly past the
    block's last row are never loaded. ``csrc/flash_attention.cu`` (``key_tiles``, ``tile_masked``)
    computes the same."""
    n_k = -(-tk // BLOCK_K)
    plan = []
    for q0 in range(0, tq, BLOCK_Q):
        q1 = min(q0 + BLOCK_Q, tq)
        tiles = min(n_k, (q1 - 1) // BLOCK_K + 1) if causal else n_k
        masked = [n for n in range(tiles)
                  if (n + 1) * BLOCK_K > tk or (causal and (n + 1) * BLOCK_K - 1 > q0)]
        plan.append((q0, q1, tiles, masked))
    return plan


def _causal_keep(tq: int, tk: int, device) -> torch.Tensor:
    """(tq, tk) bool: the TPU kernel's causal rule, key <= query, aligned at
    the first query and key (no offset when tq != tk)."""
    return (torch.arange(tk, device=device)[None, :]
            <= torch.arange(tq, device=device)[:, None])


def _softmax_pv(s: torch.Tensor, v: torch.Tensor, causal: bool,
                out_dtype: torch.dtype) -> torch.Tensor:
    """The kernels' tail: f32 scores masked at -1e30 under ``causal``, f32
    softmax, probabilities rounded to v's dtype, PV accumulated in f32."""
    if causal:
        s = s.masked_fill(~_causal_keep(s.shape[-2], s.shape[-1], s.device), NEG)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(out_dtype)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = False) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(D)) v over (..., H, T, D), the TPU kernel's contract:
    q scaled in f32 before the score product, f32 scores and softmax, masked
    scores at -1e30, the causal rule ``key <= query`` with no offset, and the
    normalised probabilities rounded to v's dtype before the PV product
    (accumulated in f32). The result has q's dtype."""
    d = q.shape[-1]
    s = torch.matmul(q.float() * d ** -0.5, k.float().transpose(-1, -2))
    return _softmax_pv(s, v, causal, q.dtype)


def quantize_rows(x: torch.Tensor):
    """Per row of (..., T, D), as the TPU kernel's ``qk_int8`` path computes
    it under XLA: scale = max(max|x|, 1e-6) * f32(1/127), codes =
    clip(round-half-even(x / scale), -127, 127) as int8. Returns (codes,
    scale (..., T, 1) f32)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) * INV_127
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def flash_attention_int8_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   causal: bool = False) -> torch.Tensor:
    """K1b's contract (``_attn_kernel(qk_int8=True)``): Q and K quantized
    per row (``quantize_rows``), the int32 score dot (exact: |s| <= 64 ·
    127² < 2^24, so an f32 product of the codes holds it exactly), scores
    s32 · (q_scale · D^-0.5) · k_scale in that order, then the f32 softmax
    and PV of ``flash_attention_reference``. The result has q's dtype."""
    q8, qs = quantize_rows(q)
    k8, ks = quantize_rows(k)
    s32 = torch.matmul(q8.float(), k8.float().transpose(-1, -2))
    s = s32 * (qs * q.shape[-1] ** -0.5) * ks.transpose(-1, -2)
    return _softmax_pv(s, v, causal, q.dtype)


def flash_sdpa_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                        causal: bool):
    """JAX's closed-form attention gradients (``_flash_sdpa_bwd``) in plain
    torch: recompute s = q kᵀ D^-0.5 and p = softmax(s) in f32; dv = pᵀ g,
    dp = g vᵀ, ds = p ⊙ (dp − Σ dp ⊙ p), dq = ds k D^-0.5, dk = dsᵀ q D^-0.5,
    each cast to its input's dtype. The causal mask is the FORWARD's rule
    (key <= query, aligned top-left); JAX's backward aligns it bottom-right,
    which agrees only when tq == tk."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, g32 = q.float(), k.float(), v.float(), g.float()
    # The (…, tq, tk) f32 tensors dominate the cost: each is updated in
    # place where it can be, and freed as soon as it is spent.
    s = torch.matmul(qf, kf.transpose(-1, -2)).mul_(scale)
    if causal:
        s.masked_fill_(~_causal_keep(s.shape[-2], s.shape[-1], s.device), NEG)
    p = torch.softmax(s, dim=-1)
    del s
    dv = torch.matmul(p.transpose(-1, -2), g32)
    dp = torch.matmul(g32, vf.transpose(-1, -2))
    ds = dp.sub_((dp * p).sum(-1, keepdim=True)).mul_(p)  # p ⊙ (dp − Σ dp ⊙ p)
    del p, dp
    dq = torch.matmul(ds, kf).mul_(scale)
    dk = torch.matmul(ds.transpose(-1, -2), qf).mul_(scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dim() < 2 or q.shape[-1] != D_HEAD:
        raise ValueError(f"flash_attention needs d_head {D_HEAD}, got q {tuple(q.shape)}")
    if k.shape != v.shape or k.shape[:-2] != q.shape[:-2] or k.shape[-1] != D_HEAD:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if q.shape[-2] == 0 or k.shape[-2] == 0:
        raise ValueError("flash_attention needs at least one query and one key")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:  # TMA reads from 16-byte aligned addresses
            raise ValueError(f"{name} must start on a 16-byte boundary")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, qk_int8: bool = False) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(D)) v over contiguous (..., H, T, D) tensors; with
    ``qk_int8`` the scores come from per-row int8 Q and K (K1b).

    CUDA tensors (f32 or bf16, D = 64) go through the CUDA kernel; CPU
    tensors through :func:`flash_attention_reference` (or
    :func:`flash_attention_int8_reference`). The kernel has no backward: a
    call with gradients enabled and an input that requires them raises
    (use :func:`flash_sdpa`). Launches are counted by kernel:
    ``flash_attention.launches`` K1's bf16 kernel, ``.f32_launches`` its f32
    kernel and ``.int8_launches`` K1b."""
    if q.device.type == "cpu":
        ref = flash_attention_int8_reference if qk_int8 else flash_attention_reference
        return ref(q, k, v, causal=causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention's kernel has no backward: take gradients "
                           "through flash_sdpa")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    from .build import load_library

    lib = load_library("flash_attention")
    tq, tk = q.shape[-2], k.shape[-2]
    bh = math.prod(q.shape[:-2])
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if qk_int8:
        fn = lib.whisper_flash_attention_qk_int8
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                   ctypes.c_void_p]
        # scratch: the int8 codes and f32 scales of every row of Q and K
        q8 = torch.empty(q.shape, dtype=torch.int8, device=q.device)
        k8 = torch.empty(k.shape, dtype=torch.int8, device=q.device)
        qs = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
        ks = torch.empty(k.shape[:-1], dtype=torch.float32, device=q.device)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q8.data_ptr(),
                qs.data_ptr(), k8.data_ptr(), ks.data_ptr())
    else:
        fn = lib.whisper_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                   ctypes.c_void_p]
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(*args, bh, tq, tk, int(causal), int(q.dtype == torch.bfloat16),
                 D_HEAD ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    if qk_int8:
        flash_attention.int8_launches += 1
    elif q.dtype == torch.bfloat16:
        flash_attention.launches += 1
    else:
        flash_attention.f32_launches += 1
    return out


flash_attention.launches = 0
flash_attention.f32_launches = 0
flash_attention.int8_launches = 0


class _FlashSDPA(torch.autograd.Function):
    """K1 forward (the kernel on the card), closed-form backward in plain
    torch; saves q, k and v (not p), as JAX's ``_flash_sdpa_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*flash_sdpa_backward(q, k, v, g, ctx.causal), None)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = False) -> torch.Tensor:
    """Differentiable :func:`flash_attention` (the training paths' K1c);
    its kernel launches are counted by ``flash_attention``."""
    return _FlashSDPA.apply(q, k, v, causal)
