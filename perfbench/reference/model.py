"""Whisper in plain float32 PyTorch, as the served configuration computes it.

The encoder is the published one (conv stem, pre-LN blocks, final LN). The
decoder's matmul weights and tied embedding are quantized per output
channel, and the cross and self keys and values per position over the head
dimension, to ``bits`` (8 in the served configuration: the scale is the
largest magnitude over 2^(bits-1) - 1, the code its quotient rounded and
clipped), then dequantized; everything is computed in float32 with TF32
off. ``encoder_bits`` quantizes the encoder's block weights the same way
(the control's lower precision; None keeps them as drawn).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

_DEC_MATS = ("q_w", "k_w", "v_w", "out_w", "mlp0_w", "mlp1_w",
             "cross_q_w", "cross_k_w", "cross_v_w", "cross_out_w")
_ENC_MATS = ("q_w", "k_w", "v_w", "out_w", "mlp0_w", "mlp1_w")


def fake_quant(x: torch.Tensor, bits: Optional[int], dim: int = -1) -> torch.Tensor:
    """x quantized symmetrically along ``dim`` (one scale per vector) to
    ``bits`` and dequantized; None returns x."""
    if bits is None:
        return x
    top = float(2 ** (bits - 1) - 1)
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8) * (1.0 / top)
    return torch.round(x / scale).clamp(-top, top) * scale


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps=1e-5)


class TF32Off:
    """float32 products in full float32 inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


class Reference:
    """The weights of one tree in float32, quantized as set; ``encode`` a
    window, ``logits`` of a token sequence against an encoded window."""

    def __init__(self, tree: dict, dims: dict, bits: Optional[int] = 8,
                 encoder_bits: Optional[int] = None):
        self.d = dims
        self.bits = bits
        f32 = torch.float32
        enc, dec = tree["encoder"], tree["decoder"]
        self.enc = {k: v.to(f32) for k, v in enc.items() if k != "blocks"}
        self.enc_blocks = [
            {k: fake_quant(v[i].to(f32), encoder_bits) if k in _ENC_MATS else v[i].to(f32)
             for k, v in enc["blocks"].items()}
            for i in range(dims["n_audio_layer"])]
        self.dec = {"pe": dec["pe"].to(f32), "ln_w": dec["ln_w"].to(f32),
                    "ln_b": dec["ln_b"].to(f32), "te": fake_quant(dec["te"].to(f32), bits)}
        self.dec_blocks = [
            {k: fake_quant(v[i].to(f32), bits) if k in _DEC_MATS else v[i].to(f32)
             for k, v in dec["blocks"].items()}
            for i in range(dims["n_text_layer"])]

    # -- attention over (H, T, D) heads --

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.unflatten(-1, (self.d["n_head"], -1)).transpose(0, 1)

    def _attend(self, q, k, v, causal: bool = False) -> torch.Tensor:
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        if causal:
            t = scores.shape[-1]
            mask = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
            scores = scores.masked_fill(mask, float("-inf"))
        return (torch.softmax(scores, dim=-1) @ v).transpose(0, 1).flatten(-2)

    @torch.no_grad()
    def encode(self, mel: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """(n_mels, 3000) -> each decoder layer's cross keys and values,
        (H, 1500, D), quantized per position to ``bits`` and dequantized."""
        with TF32Off():
            e = self.enc
            x = F.gelu(F.conv1d(mel[None], e["conv1_w"], e["conv1_b"], padding=1))
            x = F.gelu(F.conv1d(x, e["conv2_w"], e["conv2_b"], stride=2, padding=1))
            x = x[0].T + e["pe"][: x.shape[-1]]
            for b in self.enc_blocks:
                y = _ln(x, b["attn_ln_w"], b["attn_ln_b"])
                q = self._heads(y @ b["q_w"].T + b["q_b"])
                k = self._heads(y @ b["k_w"].T)
                v = self._heads(y @ b["v_w"].T + b["v_b"])
                x = x + self._attend(q, k, v) @ b["out_w"].T + b["out_b"]
                y = _ln(x, b["mlp_ln_w"], b["mlp_ln_b"])
                x = x + F.gelu(y @ b["mlp0_w"].T + b["mlp0_b"]) @ b["mlp1_w"].T + b["mlp1_b"]
            x = _ln(x, e["ln_post_w"], e["ln_post_b"])
            cross = []
            for b in self.dec_blocks:
                k = fake_quant(self._heads(x @ b["cross_k_w"].T), self.bits)
                v = fake_quant(self._heads(x @ b["cross_v_w"].T + b["cross_v_b"]), self.bits)
                cross.append((k, v))
            return cross

    @torch.no_grad()
    def logits(self, tokens: List[int], cross) -> torch.Tensor:
        """(T, n_vocab) float32 logits of a teacher-forced sequence from
        position 0: row i predicts token i + 1; the self keys and values are
        quantized to ``bits`` (the served int8 pool)."""
        bits = self.bits
        with TF32Off():
            dec = self.dec
            ids = torch.tensor(tokens, dtype=torch.long, device=dec["te"].device)
            x = dec["te"][ids] + dec["pe"][: len(tokens)]
            for b, (ck, cv) in zip(self.dec_blocks, cross):
                y = _ln(x, b["attn_ln_w"], b["attn_ln_b"])
                q = self._heads(y @ b["q_w"].T + b["q_b"])
                k = fake_quant(self._heads(y @ b["k_w"].T), bits)
                v = fake_quant(self._heads(y @ b["v_w"].T + b["v_b"]), bits)
                x = x + self._attend(q, k, v, causal=True) @ b["out_w"].T + b["out_b"]
                y = _ln(x, b["cross_attn_ln_w"], b["cross_attn_ln_b"])
                qc = self._heads(y @ b["cross_q_w"].T + b["cross_q_b"])
                x = x + self._attend(qc, ck, cv) @ b["cross_out_w"].T + b["cross_out_b"]
                y = _ln(x, b["mlp_ln_w"], b["mlp_ln_b"])
                x = x + F.gelu(y @ b["mlp0_w"].T + b["mlp0_b"]) @ b["mlp1_w"].T + b["mlp1_b"]
            x = _ln(x, dec["ln_w"], dec["ln_b"])
            return x @ dec["te"].T
