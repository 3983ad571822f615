"""Whisper audio encoder in PyTorch (bf16/f32 parity mode).

Port of ``whisper_tpu/model/encoder.py``:

    mel window (B, n_mels, 2*n_ctx)
    -> conv1 k=3 s=1 pad 1 + bias + gelu
    -> conv2 k=3 s=2 pad 1 + bias + gelu                  T: 3000 -> 1500
    -> transpose + positional embedding
    -> n_layer x [pre-LN self-attention + pre-LN MLP]
    -> final LN
    -> cross-attention K/V for every decoder layer

A Python loop over layers replaces ``lax.scan``/``vmap``. Self-attention
always goes through K1 (``kernels.flash_attention``): the CUDA kernel on a
CUDA tensor, its plain version on a CPU tensor. The float block calls it
through ``flash_sdpa``, so the encoder trains (``training/train.py``);
without inputs that require grad that is the same kernel call. The public layouts are JAX's:
cross K/V kv-major (n_text_layer, B, H, D, Ta), K pre-scaled by d^-0.25.

Weights from ``model.quant.quantize_encoder_weights`` (int8 + ``*_scale``)
switch a block to W8A8: activations are quantized per token by the fused
kernels (K3 at the two LN sites and after GELU, K2 after attention) and
multiplied int8 × int8 (``q8_matmul``). ``encode(..., quantize_kv=True)``
writes the cross memory as int8 ``QuantKV``, quantized layer by layer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..config import WhisperConfig
from ..kernels.flash_attention import flash_attention, flash_sdpa
from ..kernels.fused_quant import act_quant, gelu_quant, ln_quant
from ..kernels.ops import gelu, layer_norm, linear, merge_heads, split_heads
from .decoder import to_kv_major, wo_qlinear
from .params import Params, check_quantized, register_weights
from .quant import QuantKV, _quantize_one, q8_matmul


class EncoderOutput(NamedTuple):
    hidden: torch.Tensor   # (B, n_audio_ctx, n_audio_state)
    # (n_text_layer, B, H, D, n_audio_ctx), K pre-scaled; QuantKV when quantized
    cross_k: Union[torch.Tensor, QuantKV]
    cross_v: Union[torch.Tensor, QuantKV]


class EncoderBlock(nn.Module):
    """One pre-LN block; its weights are views of one layer of the stack."""

    def __init__(self, blk: dict, cfg: WhisperConfig):
        super().__init__()
        register_weights(self, blk)
        self.n_head = cfg.n_audio_head
        self.gelu_impl = cfg.gelu_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "q_w_scale"):
            return self._forward_w8a8(x)
        h = self.n_head
        y = layer_norm(x, self.attn_ln_w, self.attn_ln_b)
        q = linear(y, self.q_w, self.q_b)
        k = linear(y, self.k_w)  # K has no bias
        v = linear(y, self.v_w, self.v_b)
        o = flash_sdpa(split_heads(q, h).contiguous(), split_heads(k, h).contiguous(),
                       split_heads(v, h).contiguous(), False)
        x = x + linear(merge_heads(o), self.out_w, self.out_b)
        y = layer_norm(x, self.mlp_ln_w, self.mlp_ln_b)
        y = gelu(linear(y, self.mlp0_w, self.mlp0_b), self.gelu_impl)
        return x + linear(y, self.mlp1_w, self.mlp1_b)

    def _forward_w8a8(self, x: torch.Tensor) -> torch.Tensor:
        """int8 weights × per-token int8 activations. The LN output is
        quantized once for Q, K and V; attention stays in x's dtype (K1)."""
        h, dt = self.n_head, x.dtype
        y8, a_scale = ln_quant(x, self.attn_ln_w, self.attn_ln_b)
        q = q8_matmul(y8, a_scale, self.q_w, self.q_w_scale, self.q_b, dt)
        k = q8_matmul(y8, a_scale, self.k_w, self.k_w_scale, None, dt)  # K has no bias
        v = q8_matmul(y8, a_scale, self.v_w, self.v_w_scale, self.v_b, dt)
        o = flash_attention(split_heads(q, h).contiguous(), split_heads(k, h).contiguous(),
                            split_heads(v, h).contiguous())
        o8, o_scale = act_quant(merge_heads(o).contiguous())
        x = x + q8_matmul(o8, o_scale, self.out_w, self.out_w_scale, self.out_b, dt)
        m8, m_scale = ln_quant(x, self.mlp_ln_w, self.mlp_ln_b)
        y = q8_matmul(m8, m_scale, self.mlp0_w, self.mlp0_w_scale, self.mlp0_b, dt)
        g8, g_scale = gelu_quant(y, self.gelu_impl)
        return x + q8_matmul(g8, g_scale, self.mlp1_w, self.mlp1_w_scale, self.mlp1_b, dt)


_CROSS_KEYS = ("cross_k_w", "cross_v_w", "cross_v_b", "cross_k_w_scale", "cross_v_w_scale")


class AudioEncoder(nn.Module):
    """Conv stem, positional embedding, blocks, final LN, and the decoder's
    cross-attention K/V projections (they read only the encoder output)."""

    def __init__(self, params: Params, cfg: WhisperConfig):
        super().__init__()
        check_quantized(params)
        enc = params["encoder"]
        dec_blocks = params["decoder"]["blocks"]
        self.cfg = cfg
        register_weights(self, {k: v for k, v in enc.items() if k != "blocks"})
        register_weights(self, {k: dec_blocks[k] for k in _CROSS_KEYS if k in dec_blocks})
        # One view per layer from unbind: when the stack trains, its backward
        # stacks the layers' gradients once, where indexing each layer would
        # add a zero-filled gradient of the whole stack per layer.
        blocks = {k: v.unbind(0) for k, v in enc["blocks"].items()}
        self.blocks = nn.ModuleList(
            EncoderBlock({k: v[i] for k, v in blocks.items()}, cfg)
            for i in range(cfg.n_audio_layer))

    def forward(self, mel: torch.Tensor) -> EncoderOutput:
        return encode(self, mel)


def _conv_stem(enc: AudioEncoder, x: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, T) -> (B, T//2, n_state), computed in the weight dtype
    (an f32 mel must not lift a bf16 model to f32); row-major, as the
    fused-quant kernels read the rows of what follows."""
    impl = enc.cfg.gelu_impl
    x = x.to(enc.conv1_w.dtype)
    x = gelu(F.conv1d(x, enc.conv1_w, padding=1) + enc.conv1_b[None, :, None], impl)
    x = gelu(F.conv1d(x, enc.conv2_w, stride=2, padding=1) + enc.conv2_b[None, :, None], impl)
    return x.transpose(1, 2).contiguous()


def encode(encoder: AudioEncoder, mel: torch.Tensor, quantize_kv: bool = False) -> EncoderOutput:
    """Run the encoder on a mel window (B, n_mels, 2*n_audio_ctx); with
    ``quantize_kv`` the cross memory is int8 (``QuantKV``)."""
    x = _conv_stem(encoder, mel)
    x = x + encoder.pe[: x.shape[1]].to(x.dtype)[None]
    for block in encoder.blocks:
        x = block(x)
    x = layer_norm(x, encoder.ln_post_w, encoder.ln_post_b)
    cross_k, cross_v = cross_kv_from_hidden(encoder, x, quantize_kv)
    return EncoderOutput(hidden=x, cross_k=cross_k, cross_v=cross_v)


def _cross_linear(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
                  b: Optional[torch.Tensor], x_q) -> torch.Tensor:
    """One cross projection. W8A8 when the hidden state was quantized
    (``x_q``) and the weight is int8; an int8 weight alone takes its scale
    after an f32 product of x's dtype."""
    if scale is None:
        return linear(x, w, b)
    if x_q is not None:
        return q8_matmul(*x_q, w, scale, b, x.dtype)
    return wo_qlinear(x, w, scale, b)


def cross_kv_from_hidden(encoder: AudioEncoder, x: torch.Tensor, quantize_kv: bool = False):
    """Cross-attention K/V for every decoder layer, written layer by layer
    into kv-major (n_text_layer, B, H, D, Ta) outputs. With ``quantize_kv``
    each layer is quantized as it is made (the float memory is never whole),
    and a W8A8 encoder quantizes the hidden state once for all projections.
    When gradients flow (training), the float layers are stacked instead:
    a layer written into a buffer would copy the whole buffer in its
    backward."""
    cfg = encoder.cfg
    h = cfg.n_text_head
    # JAX multiplies by the scale rounded to the activation dtype.
    kscale = torch.tensor(cfg.d_head_text ** -0.25, dtype=x.dtype).item()
    B, Ta, _ = x.shape
    shape = (cfg.n_text_layer, B, h, cfg.d_head_text, Ta)
    x_q = None
    if quantize_kv and hasattr(encoder.blocks[0], "q_w_scale"):
        x_q = act_quant(x)
    k_scale = getattr(encoder, "cross_k_w_scale", None)
    v_scale = getattr(encoder, "cross_v_w_scale", None)
    k_w, v_w, v_b = (getattr(encoder, name).unbind(0)
                     for name in ("cross_k_w", "cross_v_w", "cross_v_b"))
    stack = not quantize_kv and torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, encoder.cross_k_w, encoder.cross_v_w, encoder.cross_v_b))

    if quantize_kv:
        def empty():
            return QuantKV(torch.empty(shape, dtype=torch.int8, device=x.device),
                           torch.empty(shape[:3] + shape[4:], dtype=torch.float32,
                                       device=x.device))
    elif stack:
        def empty():
            return []
    else:
        def empty():
            return torch.empty(shape, dtype=x.dtype, device=x.device)
    cross_k, cross_v = empty(), empty()
    for layer in range(cfg.n_text_layer):
        k = _cross_linear(x, k_w[layer], None if k_scale is None else k_scale[layer], None,
                          x_q) * kscale
        v = _cross_linear(x, v_w[layer], None if v_scale is None else v_scale[layer],
                          v_b[layer], x_q)
        for out, t in ((cross_k, k), (cross_v, v)):
            t = to_kv_major(t, h)
            if quantize_kv:
                q = _quantize_one(t)
                out.data[layer], out.scale[layer] = q.data, q.scale
            elif stack:
                out.append(t)
            else:
                out[layer] = t
    if stack:
        return torch.stack(cross_k), torch.stack(cross_v)
    return cross_k, cross_v
