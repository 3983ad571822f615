"""Encoder self-attention kernel (K1), its int8-score variant (K1b), the
differentiable wrapper (K1c), and their plain PyTorch versions.

``flash_attention`` is the port of ``whisper_tpu/kernels/flash_attention.py``
(``flash_attention`` -> ``_attn_kernel``). On a CUDA tensor it launches the
hand-written kernel ``csrc/flash_attention.cu`` (see the note there: for
bf16, TMA loads of 128-key K/V tiles into a ring of shared-memory stages and
``wgmma`` products with an online f32 softmax in registers, where the TPU
kernel held one head's whole K/V and score tile in VMEM; for f32, split-TF32
``mma.sync`` products, ``csrc/attention_tf32.cuh``); on a CPU tensor it
runs ``flash_attention_reference``. There is no other route: a CUDA call
that the kernel cannot take raises. ``attention_tile_plan`` states the
forward kernels' tile plans, so that the CPU tests can check them.

``flash_attention(..., qk_int8=True)`` is the TPU kernel's ``qk_int8``
option (K1b): Q and K quantized per row to int8 and an exact int32 score
dot; its plain version is ``flash_attention_int8_reference``.

``flash_sdpa`` is JAX's ``flash_sdpa`` custom VJP (K1c) as a
``torch.autograd.Function``: when a gradient will be asked, the forward is
K1 writing its row statistics too (``lse``, the plain version
``flash_attention_lse_reference``), and the backward is JAX's closed form:
on a CUDA tensor the fused kernel ``csrc/flash_attention_bwd.cu``, on a CPU
tensor ``flash_sdpa_backward``, both from ``(q, k, v, out, lse, g)``.
``backward_tile_plan`` states the backward kernel's tile plan for the CPU
tests. ``flash_attention`` itself has no backward: on a CUDA tensor it
raises when a gradient is asked of it, so gradients reach K1 only through
``flash_sdpa``.
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
F32_BLOCK_Q, F32_BLOCK_K = 128, 64  # the f32 kernel's
BWD_BLOCK_K, BWD_BLOCK_Q = 64, 64  # the backward kernel's keys per block, queries per tile


def attention_tile_plan(tq: int, tk: int, causal: bool, block_q: int = BLOCK_Q,
                        block_k: int = BLOCK_K) -> list:
    """A forward kernel's plan for one head (the bf16 kernel's tiles by
    default; the f32 kernel's are ``F32_BLOCK_Q, F32_BLOCK_K``): per block,
    ``(q0, q1, key_tiles, masked)`` with query rows ``q0 .. q1 - 1``, the
    key tiles it loads (``range(key_tiles)``, tile n holding keys ``n *
    block_k ..``) and the tiles among them that take the per-element mask:
    those holding a key ``>= tk`` (loaded as zeros) or, under ``causal``, a
    key past the block's first row. Under ``causal`` the tiles wholly past
    the block's last row are never loaded. ``csrc/flash_attention.cu``
    (``key_tiles``, ``tile_masked``) and ``csrc/attention_tf32.cuh``
    (``fwd_key_tiles``, ``fwd_tile_masked``) compute the same."""
    n_k = -(-tk // block_k)
    plan = []
    for q0 in range(0, tq, block_q):
        q1 = min(q0 + block_q, tq)
        tiles = min(n_k, (q1 - 1) // block_k + 1) if causal else n_k
        masked = [n for n in range(tiles)
                  if (n + 1) * block_k > tk or (causal and (n + 1) * block_k - 1 > q0)]
        plan.append((q0, q1, tiles, masked))
    return plan


def backward_tile_plan(tq: int, tk: int, causal: bool) -> list:
    """The backward kernel's plan for one head: per block, ``(k0, k1,
    first, q_tiles, masked)`` with keys ``k0 .. k1 - 1``, the query tiles
    it visits (``range(first, q_tiles)``, tile n holding queries ``n *
    BWD_BLOCK_Q ..``) and the tiles among them that take the per-element
    mask: every tile when the block holds a key ``>= tk``, a tile holding a
    query ``>= tq`` (both loaded as zeros) and, under ``causal``, a tile
    whose first query comes before the block's last key. Under ``causal``
    the tiles wholly before the block's first key are skipped (no query
    there sees these keys), so a block of keys past every query visits
    none and writes zero gradients. ``csrc/flash_attention_bwd.cu``
    (``bwd_first_tile``, ``bwd_tile_masked``) computes the same."""
    n_q = -(-tq // BWD_BLOCK_Q)
    plan = []
    for k0 in range(0, tk, BWD_BLOCK_K):
        first = k0 // BWD_BLOCK_Q if causal else 0
        masked = [n for n in range(first, n_q)
                  if k0 + BWD_BLOCK_K > tk or (n + 1) * BWD_BLOCK_Q > tq
                  or (causal and k0 + BWD_BLOCK_K - 1 > n * BWD_BLOCK_Q)]
        plan.append((k0, min(k0 + BWD_BLOCK_K, tk), first, n_q, masked))
    return plan


def _causal_keep(tq: int, tk: int, device) -> torch.Tensor:
    """(tq, tk) bool: the TPU kernel's causal rule, key <= query, aligned at
    the first query and key (no offset when tq != tk)."""
    return (torch.arange(tk, device=device)[None, :]
            <= torch.arange(tq, device=device)[:, None])


def _masked(s: torch.Tensor, causal: bool) -> torch.Tensor:
    """f32 scores masked at -1e30 under ``causal``."""
    if causal:
        s = s.masked_fill(~_causal_keep(s.shape[-2], s.shape[-1], s.device), NEG)
    return s


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """The kernels' f32 scores: q scaled in f32 before the product, masked
    at -1e30 under ``causal``."""
    return _masked(torch.matmul(q.float() * q.shape[-1] ** -0.5, k.float().transpose(-1, -2)),
                   causal)


def _softmax_pv(s: torch.Tensor, v: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The kernels' tail: f32 softmax, probabilities rounded to v's dtype,
    PV accumulated in f32."""
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(out_dtype)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = False) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(D)) v over (..., H, T, D), the TPU kernel's contract:
    q scaled in f32 before the score product, f32 scores and softmax, masked
    scores at -1e30, the causal rule ``key <= query`` with no offset, and the
    normalised probabilities rounded to v's dtype before the PV product
    (accumulated in f32). The result has q's dtype."""
    return _softmax_pv(_scores(q, k, causal), v, q.dtype)


def flash_attention_lse_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  causal: bool = False):
    """(``flash_attention_reference``'s output, its row statistics ``lse``
    (..., H, Tq) f32): the log-sum-exp of each row's f32 scores, ``m +
    log(Σ exp(s - m))`` with m the row's max, what the kernels write for
    the backward."""
    s = _scores(q, k, causal)
    return _softmax_pv(s, v, q.dtype), torch.logsumexp(s, dim=-1)


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
    return _softmax_pv(_masked(s, causal), v, q.dtype)


def flash_sdpa_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, g: torch.Tensor, causal: bool):
    """JAX's closed-form attention gradients (``_flash_sdpa_bwd``) in plain
    torch, as the backward kernel computes them: s = q kᵀ D^-0.5 in f32
    (masked as the forward masks), p = exp(s − lse) from the forward's row
    statistics; dv = pᵀ g, dp = g vᵀ, ds = p ⊙ (dp − delta) D^-0.5, dq = ds k,
    dk = dsᵀ q, each cast to its input's dtype. delta is JAX's Σⱼ dpᵢⱼ pᵢⱼ:
    for f32 inputs rowsum(g ⊙ out), equal to it to f32 rounding; for bf16
    rowsum(g ⊙ p v) with p in f32, since the bf16 output rounded p to bf16
    before its PV product. The causal mask is the FORWARD's rule (key <=
    query, aligned top-left); JAX's backward aligns it bottom-right, which
    agrees only when tq == tk."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, g32 = q.float(), k.float(), v.float(), g.float()
    # The (…, tq, tk) f32 tensors dominate the cost: each is updated in
    # place where it can be, and freed as soon as it is spent.
    p = _scores(q, k, causal).sub_(lse.unsqueeze(-1)).exp_()
    o32 = out.float() if q.dtype == torch.float32 else torch.matmul(p, vf)
    delta = (g32 * o32).sum(-1, keepdim=True)
    del o32
    dv = torch.matmul(p.transpose(-1, -2), g32)
    ds = torch.matmul(g32, vf.transpose(-1, -2)).sub_(delta).mul_(p).mul_(scale)
    del p
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
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


def _check_card(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            lse) -> torch.Tensor:
    """K1 (bf16 or f32) on the card; writes the row statistics into ``lse``
    unless it is None."""
    from .build import load_library

    fn = load_library("flash_attention").whisper_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), math.prod(q.shape[:-2]), q.shape[-2],
                 k.shape[-2], int(causal), int(q.dtype == torch.bfloat16), D_HEAD ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    if q.dtype == torch.bfloat16:
        flash_attention.launches += 1
    else:
        flash_attention.f32_launches += 1
    return out


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
    _check_card(q, k, v)
    if not qk_int8:
        return _launch(q, k, v, causal, None)
    from .build import load_library

    fn = load_library("flash_attention").whisper_flash_attention_qk_int8
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    # scratch: the int8 codes and f32 scales of every row of Q and K
    q8 = torch.empty(q.shape, dtype=torch.int8, device=q.device)
    k8 = torch.empty(k.shape, dtype=torch.int8, device=q.device)
    qs = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    ks = torch.empty(k.shape[:-1], dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q8.data_ptr(),
                 qs.data_ptr(), k8.data_ptr(), ks.data_ptr(), math.prod(q.shape[:-2]),
                 q.shape[-2], k.shape[-2], int(causal), int(q.dtype == torch.bfloat16),
                 D_HEAD ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.int8_launches += 1
    return out


flash_attention.launches = 0
flash_attention.f32_launches = 0
flash_attention.int8_launches = 0


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False):
    """(output, row statistics (..., H, Tq) f32): K1 writing ``lse`` too on
    a CUDA tensor, :func:`flash_attention_lse_reference` on a CPU tensor.
    No gradient flows through it (``flash_sdpa``'s forward)."""
    if q.device.type == "cpu":
        return flash_attention_lse_reference(q, k, v, causal)
    _check_card(q, k, v)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    return _launch(q, k, v, causal, lse), lse


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                             causal: bool = False):
    """(dq, dk, dv) of :func:`flash_attention` from the forward's output and
    row statistics: the fused kernel ``csrc/flash_attention_bwd.cu`` on a
    CUDA tensor (counted in ``flash_sdpa.bwd_launches``), the plain
    :func:`flash_sdpa_backward` on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_sdpa_backward(q, k, v, out, lse, g, causal)
    _check_card(q, k, v)
    for name, t, shape, dtype in (("out", out, q.shape, q.dtype), ("g", g, q.shape, q.dtype),
                                  ("lse", lse, q.shape[:-1], torch.float32)):
        if t.device != q.device or t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)} on {t.device}; the "
                             f"backward needs {dtype} {tuple(shape)} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and start on a 16-byte boundary")
    from .build import load_library

    fn = load_library("flash_attention_bwd").whisper_flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # dq is summed in f32 by atomics; delta is the kernel's scratch
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 math.prod(q.shape[:-2]), q.shape[-2], k.shape[-2], int(causal),
                 int(q.dtype == torch.bfloat16), D_HEAD ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: cudaError {err}")
    flash_sdpa.bwd_launches += 1
    return dq.to(q.dtype), dk, dv


class _FlashSDPA(torch.autograd.Function):
    """K1 forward with its row statistics, the fused backward; saves q, k,
    v, the output and lse (JAX's ``_flash_sdpa_fwd`` saves q, k and v and
    recomputes the softmax from scratch)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention_lse(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, out, lse, g.contiguous(), ctx.causal), None)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = False) -> torch.Tensor:
    """Differentiable :func:`flash_attention` (the training paths' K1c).
    Without a gradient to take (``torch.no_grad``, or no input that
    requires one) it is :func:`flash_attention`, and no row statistics are
    written. Its forward launches are counted by ``flash_attention``, its
    backward launches in ``flash_sdpa.bwd_launches``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashSDPA.apply(q, k, v, causal)
    return flash_attention(q, k, v, causal=causal)


flash_sdpa.bwd_launches = 0
