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
always goes through ``kernels.flash_attention``: the CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor. The public layouts are JAX's:
cross K/V kv-major (n_text_layer, B, H, D, Ta), K pre-scaled by d^-0.25.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from whisper_tpu.config import WhisperConfig

from ..kernels.flash_attention import flash_attention
from ..kernels.ops import gelu, layer_norm, linear, merge_heads, split_heads
from .decoder import to_kv_major
from .params import Params, check_not_quantized, register_weights


class EncoderOutput(NamedTuple):
    hidden: torch.Tensor   # (B, n_audio_ctx, n_audio_state)
    cross_k: torch.Tensor  # (n_text_layer, B, H, D, n_audio_ctx), pre-scaled
    cross_v: torch.Tensor


class EncoderBlock(nn.Module):
    """One pre-LN block; its weights are views of one layer of the stack."""

    def __init__(self, blk: dict, cfg: WhisperConfig):
        super().__init__()
        register_weights(self, blk)
        self.n_head = cfg.n_audio_head
        self.gelu_impl = cfg.gelu_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.n_head
        y = layer_norm(x, self.attn_ln_w, self.attn_ln_b)
        q = linear(y, self.q_w, self.q_b)
        k = linear(y, self.k_w)  # K has no bias
        v = linear(y, self.v_w, self.v_b)
        o = flash_attention(split_heads(q, h).contiguous(), split_heads(k, h).contiguous(),
                            split_heads(v, h).contiguous())
        x = x + linear(merge_heads(o), self.out_w, self.out_b)
        y = layer_norm(x, self.mlp_ln_w, self.mlp_ln_b)
        y = gelu(linear(y, self.mlp0_w, self.mlp0_b), self.gelu_impl)
        return x + linear(y, self.mlp1_w, self.mlp1_b)


class AudioEncoder(nn.Module):
    """Conv stem, positional embedding, blocks, final LN, and the decoder's
    cross-attention K/V projections (they read only the encoder output)."""

    def __init__(self, params: Params, cfg: WhisperConfig):
        super().__init__()
        check_not_quantized(params)
        enc = params["encoder"]
        dec_blocks = params["decoder"]["blocks"]
        self.cfg = cfg
        register_weights(self, {k: v for k, v in enc.items() if k != "blocks"})
        register_weights(self, {k: dec_blocks[k] for k in ("cross_k_w", "cross_v_w", "cross_v_b")})
        blocks = enc["blocks"]
        self.blocks = nn.ModuleList(
            EncoderBlock({k: v[i] for k, v in blocks.items()}, cfg)
            for i in range(cfg.n_audio_layer))

    def forward(self, mel: torch.Tensor) -> EncoderOutput:
        return encode(self, mel)


def _conv_stem(enc: AudioEncoder, x: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, T) -> (B, T//2, n_state), computed in the weight dtype
    (an f32 mel must not lift a bf16 model to f32)."""
    impl = enc.cfg.gelu_impl
    x = x.to(enc.conv1_w.dtype)
    x = gelu(F.conv1d(x, enc.conv1_w, padding=1) + enc.conv1_b[None, :, None], impl)
    x = gelu(F.conv1d(x, enc.conv2_w, stride=2, padding=1) + enc.conv2_b[None, :, None], impl)
    return x.transpose(1, 2)


def encode(encoder: AudioEncoder, mel: torch.Tensor) -> EncoderOutput:
    """Run the encoder on a mel window (B, n_mels, 2*n_audio_ctx)."""
    x = _conv_stem(encoder, mel)
    x = x + encoder.pe[: x.shape[1]].to(x.dtype)[None]
    for block in encoder.blocks:
        x = block(x)
    x = layer_norm(x, encoder.ln_post_w, encoder.ln_post_b)
    cross_k, cross_v = cross_kv_from_hidden(encoder, x)
    return EncoderOutput(hidden=x, cross_k=cross_k, cross_v=cross_v)


def cross_kv_from_hidden(encoder: AudioEncoder, x: torch.Tensor):
    """Cross-attention K/V for every decoder layer, written layer by layer
    into the kv-major (n_text_layer, B, H, D, Ta) outputs."""
    cfg = encoder.cfg
    h = cfg.n_text_head
    # JAX multiplies by the scale rounded to the activation dtype.
    kscale = torch.tensor(cfg.d_head_text ** -0.25, dtype=x.dtype).item()
    B, Ta, _ = x.shape
    shape = (cfg.n_text_layer, B, h, cfg.d_head_text, Ta)
    cross_k = torch.empty(shape, dtype=x.dtype, device=x.device)
    cross_v = torch.empty(shape, dtype=x.dtype, device=x.device)
    for layer in range(cfg.n_text_layer):
        cross_k[layer] = to_kv_major(linear(x, encoder.cross_k_w[layer]) * kscale, h)
        cross_v[layer] = to_kv_major(
            linear(x, encoder.cross_v_w[layer], encoder.cross_v_b[layer]), h)
    return cross_k, cross_v
