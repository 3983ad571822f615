"""Plain tensor ops shared by the encoder and decoder.

Port of ``whisper_tpu/kernels/ops.py``. Where JAX asks for an f32 result of
a product of bf16 operands (``preferred_element_type=f32``), the port
upcasts the operands: torch has no portable f32-output bf16 matmul, and a
bf16-rounded score or logit would move argmax ties. ``linear`` casts its
result back to x's dtype anyway, so a bf16 ``torch.matmul`` matches there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .flash_attention import flash_attention

NEG = -1e30


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with affine; moments in f32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


def gelu(x: torch.Tensor, impl: str = "erf") -> torch.Tensor:
    """GELU: 'erf' (openai/HF) or 'tanh' (ggml's approximation)."""
    return F.gelu(x, approximate="tanh" if impl == "tanh" else "none")


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(..., T, S) -> (..., n_head, T, d_head), a view."""
    return x.unflatten(-1, (n_head, -1)).transpose(-3, -2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(..., n_head, T, d_head) -> (..., T, S)."""
    return x.transpose(-3, -2).flatten(-2)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor | None = None, use_flash: bool | None = None,
         qk_int8: bool = False) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(D) + mask) v over (..., H, T, D) with f32 scores
    and softmax. ``mask`` is bool (True = attend) or additive. ``use_flash``
    takes ``kernels.flash_attention`` (with ``qk_int8``, its int8-score
    variant), as JAX's ``sdpa`` takes its Pallas kernel; the kernel takes no
    mask, so a mask goes to the plain product here, and a mask together
    with ``qk_int8`` raises, as JAX asserts."""
    if use_flash:
        if mask is None:
            return flash_attention(q, k, v, qk_int8=qk_int8)
        if qk_int8:
            raise ValueError("qk_int8 is only supported by the kernel (mask=None)")
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, NEG)
        else:
            logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., in) @ w(out, in)ᵀ + b, the GGML (out, in) weight convention;
    the bias is added after the product is rounded to x's dtype, as in JAX."""
    y = torch.matmul(x, w.T)
    if b is not None:
        y = y + b
    return y
