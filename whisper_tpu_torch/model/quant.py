"""int8 serving mode: int8 KV/cross memory, int8 decoder weights, W8A8 encoder.

Port of ``whisper_tpu/model/quant.py`` as plain torch, with the same
numerics:

  * K/V are int8 with PER-POSITION scales (one per (…, C) vector along
    d_head). They factor out of both attention products:
    ``logits = (q @ k8) * k_scale`` and ``out = bf16(p * v_scale) @ v8``;
  * decoder weights are int8 with per-OUTPUT-channel scales, applied to
    the f32 product (``model.decoder._plinear``);
  * the W8A8 encoder quantizes activations per token and multiplies
    int8 × int8 into int32 (``q8_matmul``), then dequantizes in JAX's order.

Trees are nested dicts of tensors, the layout of ``model.params``; the
functions return new dicts and leave their input unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.ops import NEG


class QuantKV(NamedTuple):
    """int8 KV with per-position scales: data (..., D, C) int8, scale (..., C) f32."""

    data: torch.Tensor
    scale: torch.Tensor


def _over_127(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127 as the JAX package computes it under ``jit``:
    XLA turns a division by a constant into a product with its f32
    reciprocal, which can differ from IEEE division by an ulp. The CUDA
    kernels (``csrc/fused_quant.cu``) multiply by the same constant."""
    return amax.clamp_min(1e-8) * (1.0 / 127.0)


def _quantize_one(x: torch.Tensor) -> QuantKV:
    """(..., D, C) float -> QuantKV. The arithmetic stays in x's dtype (bf16
    holds the integers up to 256 exactly); the scale is stored rounded to
    x's dtype, the divisor actually used, so dequant multiplies by it."""
    scale = _over_127(x.abs().amax(dim=-2).float()).to(x.dtype).float()
    q = torch.round(x / scale.to(x.dtype).unsqueeze(-2)).clamp(-127, 127)
    return QuantKV(data=q.to(torch.int8), scale=scale)


def quantize_kv(x: torch.Tensor) -> QuantKV:
    """(..., D, C) float -> int8 + per-position scale; a 5-D (layer-stacked)
    input is quantized one layer at a time, so the temporaries stay at one
    layer's size."""
    if x.dim() < 5:
        return _quantize_one(x)
    parts = [_quantize_one(x[i]) for i in range(x.shape[0])]
    return QuantKV(torch.stack([p.data for p in parts]), torch.stack([p.scale for p in parts]))


def qk_logits(q: torch.Tensor, kq: QuantKV) -> torch.Tensor:
    """q (B,H,T,D) against int8 K (B,H,D,C): f32 logits (B,H,T,C). The int8
    codes convert exactly to q's dtype, and that product is taken in f32."""
    raw = torch.matmul(q.float(), kq.data.float())
    return raw * kq.scale.unsqueeze(-2)


def pv_out(probs: torch.Tensor, vq: QuantKV, out_dtype: torch.dtype) -> torch.Tensor:
    """probs (B,H,T,C) f32 against int8 V (B,H,D,C); the scale folds into the
    probabilities, which round to bf16 whatever ``out_dtype`` is."""
    p = (probs * vq.scale.unsqueeze(-2)).to(torch.bfloat16)
    out = torch.matmul(p.float(), vq.data.float().transpose(-1, -2))
    return out.to(out_dtype)


def quant_sdpa(q: torch.Tensor, kq: QuantKV, vq: QuantKV, mask: Optional[torch.Tensor],
               out_dtype: torch.dtype) -> torch.Tensor:
    """Masked attention over int8 KV; ``mask`` bool, True = attend, or None."""
    logits = qk_logits(q, kq)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG)
    return pv_out(torch.softmax(logits, dim=-1), vq, out_dtype)


def init_quant_cache(cfg, batch: int, device: torch.device | str,
                     ctx: Optional[int] = None):
    """int8 self-attention cache, batch-leading: data (B,L,H,D,C) int8 and
    scale (B,L,H,C) f32, as distinct K and V buffers (each is appended in
    place). C is ``ctx`` capped at n_text_ctx."""
    L, H, D = cfg.n_text_layer, cfg.n_text_head, cfg.d_head_text
    C = min(ctx or cfg.n_text_ctx, cfg.n_text_ctx)

    def one():
        return QuantKV(torch.zeros((batch, L, H, D, C), dtype=torch.int8, device=device),
                       torch.zeros((batch, L, H, C), dtype=torch.float32, device=device))

    return one(), one()


# ---- weight-only int8 (decoder) ----

_WEIGHT_KEYS = (
    "q_w", "k_w", "v_w", "out_w", "mlp0_w", "mlp1_w",
    "cross_q_w", "cross_k_w", "cross_v_w", "cross_out_w",
)
_ENC_WEIGHT_KEYS = ("q_w", "k_w", "v_w", "out_w", "mlp0_w", "mlp1_w")


def quantize_weight(w: torch.Tensor):
    """(..., O, I) float -> (int8, per-O f32 scale); a leading layer axis is
    allowed."""
    wf = w.float()
    scale = _over_127(wf.abs().amax(dim=-1))
    q = torch.round(wf / scale.unsqueeze(-1)).clamp(-127, 127).to(torch.int8)
    return q, scale


def _quantize_blocks(blocks: dict, keys) -> dict:
    blocks = dict(blocks)
    for key in keys:
        blocks[key], blocks[key + "_scale"] = quantize_weight(blocks[key])
    return blocks


def quantize_decoder_weights(params: dict) -> dict:
    """The decoder's matmul weights and tied embedding in int8 with
    per-output-channel scales (``*_scale``, ``te_scale``)."""
    dec = dict(params["decoder"])
    dec["blocks"] = _quantize_blocks(dec["blocks"], _WEIGHT_KEYS)
    dec["te"], dec["te_scale"] = quantize_weight(dec["te"])
    return dict(params, decoder=dec)


def quantize_encoder_weights(params: dict) -> dict:
    """The encoder blocks' matmul weights in int8 with per-output-channel
    scales; the encoder then runs W8A8 (conv stem, positional embedding and
    layer norms stay in the model dtype)."""
    enc = dict(params["encoder"])
    enc["blocks"] = _quantize_blocks(enc["blocks"], _ENC_WEIGHT_KEYS)
    return dict(params, encoder=enc)


def fuse_decoder_qkv(params: dict) -> dict:
    """Concatenate each decoder block's Q/K/V projections into one
    (3*n_state, n_state) ``qkv_w`` with ``qkv_b`` (K's missing bias as zeros)
    and, for an int8 tree, ``qkv_w_scale``. Quantize first: per-output
    scales then concatenate exactly."""
    dec = dict(params["decoder"])
    blocks = dict(dec["blocks"])
    q_w, k_w, v_w = blocks.pop("q_w"), blocks.pop("k_w"), blocks.pop("v_w")
    q_b, v_b = blocks.pop("q_b"), blocks.pop("v_b")
    blocks["qkv_w"] = torch.cat([q_w, k_w, v_w], dim=-2)
    blocks["qkv_b"] = torch.cat([q_b, torch.zeros_like(q_b), v_b], dim=-1)
    if "q_w_scale" in blocks:
        blocks["qkv_w_scale"] = torch.cat(
            [blocks.pop("q_w_scale"), blocks.pop("k_w_scale"), blocks.pop("v_w_scale")], dim=-1)
    dec["blocks"] = blocks
    return dict(params, decoder=dec)


# ---- W8A8 encoder ----

def quantize_act(y: torch.Tensor):
    """Per-token int8: (..., I) float -> ((..., I) int8, (..., 1) f32 scale)."""
    yf = y.float()
    a_scale = _over_127(yf.abs().amax(dim=-1, keepdim=True))
    y8 = torch.round(yf / a_scale).clamp(-127, 127).to(torch.int8)
    return y8, a_scale


def q8_matmul(y8: torch.Tensor, a_scale: torch.Tensor, w8: torch.Tensor,
              w_scale: torch.Tensor, b: Optional[torch.Tensor],
              out_dtype: torch.dtype) -> torch.Tensor:
    """int8 (..., I) × int8 (O, I)ᵀ with int32 accumulation, dequantized in
    JAX's order: ``(acc * a_scale * w_scale)`` in f32, cast, then ``+ b``.

    ``torch._int_mm`` is a library product, as JAX left this one to XLA; it
    needs more than 16 rows and I, O multiples of 8 (every Whisper size)."""
    acc = torch._int_mm(y8.reshape(-1, y8.shape[-1]), w8.T).unflatten(0, y8.shape[:-1])
    out = (acc.float() * a_scale * w_scale).to(out_dtype)
    if b is not None:
        out = out + b
    return out


def dyn_qlinear(y: torch.Tensor, w8: torch.Tensor, w_scale: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y (..., I) @ w8ᵀ with the activation quantized per token (W8A8)."""
    y8, a_scale = quantize_act(y)
    return q8_matmul(y8, a_scale, w8, w_scale, b, y.dtype)
