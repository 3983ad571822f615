"""Encoder self-attention kernel (K1) and its plain PyTorch version.

``flash_attention`` is the port of ``whisper_tpu/kernels/flash_attention.py``
(``flash_attention`` -> ``_attn_kernel``). On a CUDA tensor it launches the
hand-written kernel ``csrc/flash_attention.cu`` (see the note there: for
bf16, TMA loads of 128-key K/V tiles into a ring of shared-memory stages and
``wgmma`` products with an online f32 softmax in registers, where the TPU
kernel held one head's whole K/V and score tile in VMEM); on a CPU tensor it
runs ``flash_attention_reference``. There is no other route: a CUDA call
that the kernel cannot take raises. ``attention_tile_plan`` states the bf16
kernel's tile plan, so that the CPU tests can check it.

Not ported yet: the ``qk_int8`` score path (unwired in the JAX package) and
the ``flash_sdpa`` backward (training only).
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG = -1e30
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


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = False) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(D)) v over (..., H, T, D), the TPU kernel's contract:
    q scaled in f32 before the score product, f32 scores and softmax, masked
    scores at -1e30, the causal rule ``key <= query`` with no offset, and the
    normalised probabilities rounded to v's dtype before the PV product
    (accumulated in f32). The result has q's dtype."""
    d = q.shape[-1]
    s = torch.matmul(q.float() * d ** -0.5, k.float().transpose(-1, -2))
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        keep = (torch.arange(tk, device=s.device)[None, :]
                <= torch.arange(tq, device=s.device)[:, None])
        s = s.masked_fill(~keep, NEG)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


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
                    causal: bool = False) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(D)) v over contiguous (..., H, T, D) tensors.

    CUDA tensors (f32 or bf16, D = 64) go through the CUDA kernel; CPU
    tensors through :func:`flash_attention_reference`. ``flash_attention.
    launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    from .build import load_library

    lib = load_library("flash_attention")
    fn = lib.whisper_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                               ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tq, tk = q.shape[-2], k.shape[-2]
    bh = math.prod(q.shape[:-2])
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, tq, tk, int(causal), int(q.dtype == torch.bfloat16),
                 D_HEAD ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
