"""Whisper text decoder with a KV cache, in PyTorch (bf16/f32 parity mode).

Port of ``whisper_tpu/model/decoder.py``, at a scalar ``n_past`` or, at
T = 1, a per-row (B,) ``n_past`` tensor (the serving engine's slots):

  * the self-attention cache is batch-leading and kv-major,
    (B, n_layer, H, d_head, ctx), as in JAX; the new K/V columns are written
    IN PLACE at ``n_past`` (JAX's ``dynamic_update_slice`` is functional);
  * cross-attention reads the encoder's memory, K pre-scaled by d^-0.25 and
    Q scaled by the same factor here;
  * logits are the tied token embedding's transpose, in f32;
  * self-attention over the float cache runs the decode-attention kernel
    (K5, ``kernels.decode_attention``), reading one cache layer in place;
  * group-shared cross memory: when the cross batch G is smaller than the
    decoder batch G·k (beam rows, group-contiguous), the k rows of a group
    fold into the query's T axis, so each group's memory is read once.

int8 serving mode (``model.quant``): int8 weights with ``*_scale`` entries
go through ``_plinear`` (weight-only, the scale after an f32 product), a
fused ``qkv_w`` replaces Q/K/V, an int8 tied embedding carries
``te_scale``, and ``QuantKV`` cross memory and self cache are read by the
int8 decode-attention kernel (K4, ``kernels.cross_attention_int8``).

``cross_attention_probs`` runs one causal forward over a teacher-forced
sequence and returns every layer's cross-attention distribution, the
alignment signal of word timing (``pipeline/word_timing.py``).

Not ported yet: the ragged multi-token verify block and ``defer_append``
(speculative decoding, ROADMAP item 14). Not carried over: ``permute_rows``,
``decode_step_chunk``, ``_chunk_block`` and ``init_tail``, the JAX beam
engine's chunked copy-on-write (a read-only pool, a per-chunk tail and one
permute and flush a chunk, against XLA's whole-pool rewrites); the port's
beam engine forks rows in place with K7 and reads the pool as this module's
ragged path does (``parallel.beam_engine``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from ..config import WhisperConfig
from ..kernels.cross_attention_int8 import cross_attention_int8
from ..kernels.decode_attention import cached_attention
from ..kernels.ops import gelu, layer_norm, linear, merge_heads, split_heads
from .params import Params, check_quantized, register_weights
from .quant import QuantKV, _quantize_one


NPast = Union[int, torch.Tensor]  # one position for every row, or (B,) int32 on the device


class KVCache(NamedTuple):
    # (B, n_layer, H, d_head, ctx); QuantKV (model.quant.init_quant_cache) for int8
    k: Union[torch.Tensor, QuantKV]
    v: Union[torch.Tensor, QuantKV]


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


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., I) @ w (O, I)ᵀ with an f32 result from operands of x's dtype
    (JAX's ``preferred_element_type=f32``); an int8 w converts exactly. On
    CUDA the product writes f32 itself (``torch.mm(..., out_dtype=)``); on
    the CPU, where that op has no kernel, the operands are upcast. The
    products are exact in f32 either way; only the order of the sums differs."""
    w = w.to(x.dtype)
    if x.device.type == "cuda":
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.T, out_dtype=torch.float32)
        return y.unflatten(0, x.shape[:-1])
    return torch.matmul(x.float(), w.float().T)


def _scalar(value: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to ``dtype``, as JAX's weak typing multiplies."""
    return torch.tensor(value, dtype=dtype).item()


def _plinear(y: torch.Tensor, blk: nn.Module, name: str,
             bias_name: Optional[str] = None) -> torch.Tensor:
    """linear() that takes an int8 weight with its per-output-channel
    ``<name>_scale`` through ``wo_qlinear``."""
    w = getattr(blk, name)
    s = getattr(blk, name + "_scale", None)
    b = getattr(blk, bias_name) if bias_name else None
    return linear(y, w, b) if s is None else wo_qlinear(y, w, s, b)


def wo_qlinear(y: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weight-only int8 linear: the per-output-channel scale multiplies the
    f32 product, then the result rounds to y's dtype and the bias is added."""
    out = (matmul_f32(y, w8) * scale).to(y.dtype)
    return out + b if b is not None else out


def _project_qkv(y, blk: "DecoderBlock", h: int):
    """Self-attention projections: q (B,H,T,D), new K/V (B,H,D,T); one
    matmul when the block carries a fused ``qkv_w``."""
    if hasattr(blk, "qkv_w"):
        qkv = _plinear(y, blk, "qkv_w", "qkv_b")
        n = qkv.shape[-1] // 3
        return (split_heads(qkv[..., :n], h), to_kv_major(qkv[..., n:2 * n], h),
                to_kv_major(qkv[..., 2 * n:], h))
    q = split_heads(_plinear(y, blk, "q_w", "q_b"), h)
    k_new = to_kv_major(_plinear(y, blk, "k_w"), h)  # no bias
    v_new = to_kv_major(_plinear(y, blk, "v_w", "v_b"), h)
    return q, k_new, v_new


def _cross_mlp(x, blk: "DecoderBlock", cross_k, cross_v, cfg: WhisperConfig):
    """Cross-attention over the encoder memory (float, or int8 ``QuantKV``
    through K4), then the MLP; returns (x, cross probabilities or None). A
    cross batch G smaller than the decoder batch B = G·k is group-shared:
    the k rows of a group (contiguous) fold into the query's T axis, so K4
    reads each group's memory once. A float cross memory goes through a
    plain f32 softmax (``_kvmajor_sdpa``'s steps, no kernel returns the
    distribution), whose probabilities (G, H, k·T, Ta) are returned."""
    h, d = cfg.n_text_head, cfg.d_head_text
    B, T, _ = x.shape
    Bc = getattr(cross_k, "data", cross_k).shape[0]
    if B % Bc:
        raise ValueError(f"decoder batch {B} is not a multiple of the cross batch {Bc}")
    kk = B // Bc
    y = layer_norm(x, blk.cross_attn_ln_w, blk.cross_attn_ln_b)
    qc = split_heads(_plinear(y, blk, "cross_q_w", "cross_q_b"), h)
    # cross_k carries d^-0.25; JAX multiplies q by the rest rounded to q's dtype.
    qc = qc * _scalar(d ** -0.25, qc.dtype)
    if kk > 1:  # (G·k, H, T, D) -> (G, H, k·T, D)
        qc = qc.unflatten(0, (Bc, kk)).transpose(1, 2).reshape(Bc, h, kk * T, d)
    probs = None
    if isinstance(cross_k, QuantKV):
        o = cross_attention_int8(qc.contiguous(), cross_k.data, cross_k.scale,
                                 cross_v.data, cross_v.scale)
    else:
        probs = torch.softmax(torch.matmul(qc.float(), cross_k.float()), dim=-1)
        o = torch.matmul(probs.to(cross_v.dtype).float(),
                         cross_v.float().transpose(-1, -2)).to(qc.dtype)
    if kk > 1:
        o = o.unflatten(2, (kk, T)).transpose(1, 2).reshape(B, h, T, d)
    x = x + _plinear(merge_heads(o), blk, "cross_out_w", "cross_out_b")
    y = layer_norm(x, blk.mlp_ln_w, blk.mlp_ln_b)
    y = gelu(_plinear(y, blk, "mlp0_w", "mlp0_b"), cfg.gelu_impl)
    return x + _plinear(y, blk, "mlp1_w", "mlp1_b"), probs


class DecoderBlock(nn.Module):
    """One decoder block; its weights are views of one layer of the stack."""

    def __init__(self, blk: dict, cfg: WhisperConfig):
        super().__init__()
        register_weights(self, blk)
        self.cfg = cfg

    def forward(self, x, cache: KVCache, layer: int, cross_k, cross_v, n_past: NPast):
        """Causal self-attention over the cache, then cross-attention and
        MLP; returns (x, cross probabilities or None, see ``_cross_mlp``).
        The T new K/V columns are written into ``cache`` in place at
        ``n_past`` (an int: clamped, like ``dynamic_update_slice``, so they
        fit; a (B,) tensor at T = 1: row b's column at n_past[b], dropped
        where that is past the cache, like JAX's scatter); an int8 cache
        takes them quantized, codes and scales."""
        cfg = self.cfg
        h, d = cfg.n_text_head, cfg.d_head_text
        T = x.shape[1]
        C = getattr(cache.k, "data", cache.k).shape[-1]
        y = layer_norm(x, self.attn_ln_w, self.attn_ln_b)
        q, k_new, v_new = _project_qkv(y, self, h)
        ragged = isinstance(n_past, torch.Tensor)
        start = 0 if ragged else max(0, min(n_past, C - T))
        if isinstance(cache.k, QuantKV):
            for buf, new in ((cache.k, k_new), (cache.v, v_new)):
                q8 = _quantize_one(new)
                if ragged:
                    _append_rows(buf.data, layer, q8.data[..., 0], n_past)
                    _append_rows(buf.scale, layer, q8.scale[..., 0], n_past)
                else:
                    buf.data[:, layer, :, :, start:start + T] = q8.data
                    buf.scale[:, layer, :, start:start + T] = q8.scale
            qs = q * _scalar(d ** -0.5, q.dtype)
            o = cross_attention_int8(qs.contiguous(), cache.k.data[:, layer],
                                     cache.k.scale[:, layer], cache.v.data[:, layer],
                                     cache.v.scale[:, layer], n_past=n_past)
        else:
            if ragged:
                _append_rows(cache.k, layer, k_new[..., 0].to(cache.k.dtype), n_past)
                _append_rows(cache.v, layer, v_new[..., 0].to(cache.v.dtype), n_past)
            else:
                cache.k[:, layer, :, :, start:start + T] = k_new
                cache.v[:, layer, :, :, start:start + T] = v_new
            o = cached_attention(q.contiguous(), cache.k[:, layer], cache.v[:, layer], n_past)
        x = x + _plinear(merge_heads(o), self, "out_w", "out_b")
        return _cross_mlp(x, self, cross_k, cross_v, cfg)


def _append_rows(buf: torch.Tensor, layer: int, new: torch.Tensor, n_past: torch.Tensor) -> None:
    """Write ``new`` (B, ...) into ``buf`` (B, L, ..., C) at (b, layer, ...,
    n_past[b]) in place: the ragged T = 1 append. A row whose n_past is past
    the cache keeps its buffer as it was (JAX's scatter drops that write);
    the column index is clamped so that nothing past C is addressed, and
    no value of ``n_past`` is read on the host."""
    C = buf.shape[-1]
    rows = torch.arange(buf.shape[0], device=buf.device)
    col = n_past.clamp(0, C - 1)
    idx = (rows, layer) + (slice(None),) * (buf.dim() - 3) + (col,)
    keep = (n_past >= C).reshape((-1,) + (1,) * (new.dim() - 1))
    buf[idx] = torch.where(keep, buf[idx], new)


class TextDecoder(nn.Module):
    """Token + positional embedding, blocks, final LN, tied-embedding logits."""

    def __init__(self, params: Params, cfg: WhisperConfig):
        super().__init__()
        check_quantized(params)
        dec = params["decoder"]
        self.cfg = cfg
        register_weights(self, {k: v for k, v in dec.items() if k != "blocks"})
        blocks = dec["blocks"]
        self.blocks = nn.ModuleList(
            DecoderBlock({k: v[i] for k, v in blocks.items()}, cfg)
            for i in range(cfg.n_text_layer))

    def forward(self, tokens, n_past: NPast, cache: KVCache, cross_k, cross_v):
        return decode_step(self, tokens, n_past, cache, cross_k, cross_v)


def _layer(cross, layer: int):
    """One decoder layer of the (L, ...) cross memory, float or QuantKV."""
    if isinstance(cross, QuantKV):
        return QuantKV(cross.data[layer], cross.scale[layer])
    return cross[layer]


def decode_step(decoder: TextDecoder, tokens: torch.Tensor, n_past: NPast, cache: KVCache,
                cross_k, cross_v) -> Tuple[torch.Tensor, KVCache]:
    """Forward ``T`` new tokens (B, T) at position ``n_past``; returns
    (logits (B, T, n_vocab) f32, cache), the cache updated in place. The
    cross memory (L, B, H, D, Ta) is float or ``QuantKV``.

    ``n_past`` is an int shared by every row, or a (B,) int32 tensor on the
    model's device with each row's own position (the engine's slots; T = 1
    only): key ``c`` is then seen by row b iff c <= n_past[b], and the new
    column goes to n_past[b]. The tensor never reaches the host.

    Padded tail positions write garbage K/V past ``n_past + true_len``;
    callers advance ``n_past`` by the true length only, so the next call
    overwrites them. Token ids out of range are wrapped and clamped as JAX's
    gather does, where torch indexing would raise."""
    if isinstance(n_past, torch.Tensor) and tokens.shape[1] != 1:
        raise NotImplementedError(
            "a (B,) n_past with T > 1 is the speculative verify block, which the port "
            "does not have yet (ROADMAP item 14)")
    x = _embed(decoder, tokens, n_past)
    for layer, block in enumerate(decoder.blocks):
        x, _ = block(x, cache, layer, _layer(cross_k, layer), _layer(cross_v, layer), n_past)
    x = layer_norm(x, decoder.ln_w, decoder.ln_b)
    te_scale = getattr(decoder, "te_scale", None)
    if te_scale is None:
        return torch.matmul(x.float(), decoder.te.float().T), cache
    return matmul_f32(x, decoder.te) * te_scale, cache


def _embed(decoder: TextDecoder, tokens: torch.Tensor, n_past: NPast) -> torch.Tensor:
    """Token embedding (ids wrapped and clamped) plus the positional
    embedding from ``n_past`` (an int: a slice, clamped as ``dynamic_slice``
    clamps it; a (B,) tensor: gathered per row, each index clamped as JAX's
    gather clamps it), in the positional embedding's dtype."""
    T = tokens.shape[1]
    V = decoder.te.shape[0]
    te_scale = getattr(decoder, "te_scale", None)
    ids = torch.where(tokens < 0, tokens + V, tokens).clamp(0, V - 1)
    x = decoder.te[ids].to(decoder.pe.dtype)
    if te_scale is not None:
        x = x * te_scale[ids][..., None].to(x.dtype)
    P = decoder.pe.shape[0]
    if isinstance(n_past, torch.Tensor):
        pos = n_past[:, None] + torch.arange(T, device=n_past.device)[None, :]
        return x + decoder.pe[pos.clamp(0, P - 1)]
    start = max(0, min(n_past, P - T))  # dynamic_slice clamps
    return x + decoder.pe[start:start + T][None]


def cross_attention_probs(decoder: TextDecoder, tokens: torch.Tensor, cross_k,
                          cross_v) -> torch.Tensor:
    """One causal forward over the teacher-forced ``tokens`` (B, T) from
    position 0, into a throwaway float cache of T positions (self-attention
    through K5, as ``decode_step``'s prefill); returns the cross-attention
    distribution of every layer, (L, B, H, T, Ta) f32. The cross memory
    is float, its batch B."""
    B, T = tokens.shape
    x = _embed(decoder, tokens, 0)
    cache = init_cache(decoder.cfg, B, x.dtype, x.device, ctx=T)
    probs = []
    for layer, block in enumerate(decoder.blocks):
        x, p = block(x, cache, layer, _layer(cross_k, layer), _layer(cross_v, layer), 0)
        probs.append(p)
    return torch.stack(probs)
