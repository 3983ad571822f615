"""Whisper text decoder with a KV cache, in PyTorch (bf16/f32 parity mode).

Port of ``whisper_tpu/model/decoder.py`` for a scalar ``n_past``:

  * the self-attention cache is batch-leading and kv-major,
    (B, n_layer, H, d_head, ctx), as in JAX; the new K/V columns are written
    IN PLACE at ``n_past`` (JAX's ``dynamic_update_slice`` is functional);
  * cross-attention reads the encoder's memory, K pre-scaled by d^-0.25 and
    Q scaled by the same factor here;
  * logits are the tied token embedding's transpose, in f32.

Not ported yet: ``permute_rows``, ragged ``n_past``, ``defer_append``, the
int8 cache, ``decode_step_chunk`` and ``cross_attention_probs``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from whisper_tpu.config import WhisperConfig

from ..kernels.ops import NEG, gelu, layer_norm, linear, merge_heads, split_heads
from .params import Params, check_not_quantized, register_weights


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, n_layer, H, d_head, ctx)
    v: torch.Tensor


def init_cache(cfg: WhisperConfig, batch: int, dtype: torch.dtype,
               device: torch.device | str, ctx: Optional[int] = None) -> KVCache:
    """Zeroed cache of ``ctx`` positions (default and cap: n_text_ctx)."""
    c = min(ctx if ctx is not None else cfg.n_text_ctx, cfg.n_text_ctx)
    shape = (batch, cfg.n_text_layer, cfg.n_text_head, cfg.d_head_text, c)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def to_kv_major(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(..., T, S) -> (..., H, D, T), a view."""
    return x.unflatten(-1, (n_head, -1)).movedim(-3, -1)


def _kvmajor_sdpa(q, k, v, mask: Optional[torch.Tensor], scale: float):
    """softmax(q kᵀ * scale, masked) v with f32 scores and softmax.

    q (B,H,T,D) head-split; k/v (B,H,D,C) kv-major; mask bool (T,C)
    broadcastable, True = attend, or None for all keys."""
    logits = torch.matmul(q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float().transpose(-1, -2)).to(q.dtype)


def _project_qkv(y, blk: "DecoderBlock", h: int):
    """Self-attention projections: q (B,H,T,D), new K/V (B,H,D,T)."""
    q = split_heads(linear(y, blk.q_w, blk.q_b), h)
    k_new = to_kv_major(linear(y, blk.k_w), h)  # no bias
    v_new = to_kv_major(linear(y, blk.v_w, blk.v_b), h)
    return q, k_new, v_new


def _cross_mlp(x, blk: "DecoderBlock", cross_k, cross_v, cfg: WhisperConfig):
    """Cross-attention over the encoder memory, then the MLP."""
    h, d = cfg.n_text_head, cfg.d_head_text
    if cross_k.shape[0] != x.shape[0]:
        raise NotImplementedError("group-shared cross memory (beam groups) is not ported yet")
    y = layer_norm(x, blk.cross_attn_ln_w, blk.cross_attn_ln_b)
    qc = split_heads(linear(y, blk.cross_q_w, blk.cross_q_b), h)
    # cross_k carries d^-0.25; JAX multiplies q by the rest rounded to q's dtype.
    qc = qc * torch.tensor(d ** -0.25, dtype=qc.dtype).item()
    o = _kvmajor_sdpa(qc, cross_k, cross_v, None, 1.0)
    x = x + linear(merge_heads(o), blk.cross_out_w, blk.cross_out_b)
    y = layer_norm(x, blk.mlp_ln_w, blk.mlp_ln_b)
    y = gelu(linear(y, blk.mlp0_w, blk.mlp0_b), cfg.gelu_impl)
    return x + linear(y, blk.mlp1_w, blk.mlp1_b)


class DecoderBlock(nn.Module):
    """One decoder block; its weights are views of one layer of the stack."""

    def __init__(self, blk: dict, cfg: WhisperConfig):
        super().__init__()
        register_weights(self, blk)
        self.cfg = cfg

    def forward(self, x, cache: KVCache, layer: int, cross_k, cross_v, n_past: int):
        """Causal self-attention over the cache, then cross-attention and
        MLP. The T new K/V columns are written into ``cache`` in place at
        ``n_past`` (clamped, like ``dynamic_update_slice``, so they fit)."""
        cfg = self.cfg
        h, d = cfg.n_text_head, cfg.d_head_text
        T = x.shape[1]
        C = cache.k.shape[-1]
        y = layer_norm(x, self.attn_ln_w, self.attn_ln_b)
        q, k_new, v_new = _project_qkv(y, self, h)
        start = max(0, min(n_past, C - T))
        cache.k[:, layer, :, :, start:start + T] = k_new
        cache.v[:, layer, :, :, start:start + T] = v_new
        key_pos = torch.arange(C, device=x.device)[None, :]
        q_pos = n_past + torch.arange(T, device=x.device)[:, None]
        o = _kvmajor_sdpa(q, cache.k[:, layer], cache.v[:, layer], key_pos <= q_pos, d ** -0.5)
        x = x + linear(merge_heads(o), self.out_w, self.out_b)
        return _cross_mlp(x, self, cross_k, cross_v, cfg)


class TextDecoder(nn.Module):
    """Token + positional embedding, blocks, final LN, tied-embedding logits."""

    def __init__(self, params: Params, cfg: WhisperConfig):
        super().__init__()
        check_not_quantized(params)
        dec = params["decoder"]
        self.cfg = cfg
        register_weights(self, {k: v for k, v in dec.items() if k != "blocks"})
        blocks = dec["blocks"]
        self.blocks = nn.ModuleList(
            DecoderBlock({k: v[i] for k, v in blocks.items()}, cfg)
            for i in range(cfg.n_text_layer))

    def forward(self, tokens, n_past: int, cache: KVCache, cross_k, cross_v):
        return decode_step(self, tokens, n_past, cache, cross_k, cross_v)


def decode_step(decoder: TextDecoder, tokens: torch.Tensor, n_past: int, cache: KVCache,
                cross_k: torch.Tensor, cross_v: torch.Tensor
                ) -> Tuple[torch.Tensor, KVCache]:
    """Forward ``T`` new tokens (B, T) at position ``n_past``; returns
    (logits (B, T, n_vocab) f32, cache), the cache updated in place.

    Padded tail positions write garbage K/V past ``n_past + true_len``;
    callers advance ``n_past`` by the true length only, so the next call
    overwrites them. Token ids out of range are wrapped and clamped as JAX's
    gather does, where torch indexing would raise."""
    T = tokens.shape[1]
    V = decoder.te.shape[0]
    ids = torch.where(tokens < 0, tokens + V, tokens).clamp(0, V - 1)
    x = decoder.te[ids].to(decoder.pe.dtype)
    start = max(0, min(n_past, decoder.pe.shape[0] - T))  # dynamic_slice clamps
    x = x + decoder.pe[start:start + T][None]
    for layer, block in enumerate(decoder.blocks):
        x = block(x, cache, layer, cross_k[layer], cross_v[layer], n_past)
    x = layer_norm(x, decoder.ln_w, decoder.ln_b)
    logits = torch.matmul(x.float(), decoder.te.float().T)
    return logits, cache
