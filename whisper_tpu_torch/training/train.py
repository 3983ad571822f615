"""Training: the teacher-forced loss and the AdamW train step.

Port of ``whisper_tpu/training/train.py`` for one device. The forward is
the encoder (``model.encoder.encode``, its modules built from the params
tree at every call, so their weights are views of leaves that require
grad) and a teacher-forced decoder over the whole token sequence, with no
cache; the decoder's causal self-attention and the encoder's self-attention
run K1 through ``flash_sdpa`` (the CUDA kernel forward on the card, the
closed-form backward in plain torch), cross-attention the plain
``_kvmajor_sdpa``, as JAX's is XLA. The logits are f32 against the tied
embedding, the loss a masked next-token cross entropy in f32.

The optimizer is ``torch.optim.AdamW`` set up as optax's ``adamw``: betas
(0.9, 0.999), eps 1e-8 added to sqrt(v̂), decay on every leaf scaled by the
learning rate, and a schedule read at the update count before it is
incremented, as optax reads it (the first update of a warm-up from 0 has
lr 0). JAX's train step is functional; here ``train_step`` updates the
state's leaves and optimizer moments in place and returns the state with
its step advanced.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Union

import torch
import torch.nn.functional as F

from ..config import WhisperConfig
from ..kernels.decode_attention import _kvmajor_sdpa
from ..kernels.flash_attention import flash_sdpa
from ..kernels.ops import gelu, layer_norm, linear, merge_heads, split_heads
from ..model.decoder import _scalar
from ..model.encoder import AudioEncoder, encode
from ..model.params import Params


def decoder_forward_train(params: Params, tokens: torch.Tensor, cross_k: torch.Tensor,
                          cross_v: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """Teacher-forced decoder over tokens (B, T): no KV cache, keys and
    values computed in place; cross memory (L, B, H, D, Ta), K pre-scaled
    by d^-0.25. Returns f32 logits (B, T, n_vocab)."""
    dec = params["decoder"]
    T = tokens.shape[1]
    V = dec["te"].shape[0]
    h, d = cfg.n_text_head, cfg.d_head_text
    ids = torch.where(tokens < 0, tokens + V, tokens).clamp(0, V - 1)  # JAX's gather clamps
    x = dec["te"][ids].to(dec["pe"].dtype) + dec["pe"][:T][None]
    # unbind, not an index per layer: its backward stacks the layers'
    # gradients once (see model.encoder.AudioEncoder)
    layers = {name: leaf.unbind(0) for name, leaf in dec["blocks"].items()}
    cross_k, cross_v = cross_k.unbind(0), cross_v.unbind(0)
    for i in range(cfg.n_text_layer):
        blk = {name: leaf[i] for name, leaf in layers.items()}
        y = layer_norm(x, blk["attn_ln_w"], blk["attn_ln_b"])
        q = split_heads(linear(y, blk["q_w"], blk["q_b"]), h).contiguous()
        k = split_heads(linear(y, blk["k_w"]), h).contiguous()  # K has no bias
        v = split_heads(linear(y, blk["v_w"], blk["v_b"]), h).contiguous()
        o = flash_sdpa(q, k, v, True)
        x = x + linear(merge_heads(o), blk["out_w"], blk["out_b"])
        y = layer_norm(x, blk["cross_attn_ln_w"], blk["cross_attn_ln_b"])
        qc = split_heads(linear(y, blk["cross_q_w"], blk["cross_q_b"]), h)
        # cross K carries d^-0.25; q takes the rest, rounded to its dtype as in JAX
        o = _kvmajor_sdpa(qc * _scalar(d ** -0.25, qc.dtype), cross_k[i], cross_v[i], None, 1.0)
        x = x + linear(merge_heads(o), blk["cross_out_w"], blk["cross_out_b"])
        y = layer_norm(x, blk["mlp_ln_w"], blk["mlp_ln_b"])
        y = gelu(linear(y, blk["mlp0_w"], blk["mlp0_b"]), cfg.gelu_impl)
        x = x + linear(y, blk["mlp1_w"], blk["mlp1_b"])
    x = layer_norm(x, dec["ln_w"], dec["ln_b"])
    return torch.matmul(x.float(), dec["te"].float().T)


def loss_fn(params: Params, mel: torch.Tensor, tokens: torch.Tensor, token_mask: torch.Tensor,
            cfg: WhisperConfig) -> torch.Tensor:
    """Next-token cross entropy, masked, in f32. mel (B, n_mels, 2*ctx),
    tokens and token_mask (B, T)."""
    enc = encode(AudioEncoder(params, cfg), mel)
    logits = decoder_forward_train(params, tokens[:, :-1], enc.cross_k, enc.cross_v, cfg)
    targets = tokens[:, 1:].long()
    mask = token_mask[:, 1:].float()
    ce = F.cross_entropy(logits.flatten(0, 1), targets.flatten(), reduction="none")
    return (ce.view_as(mask) * mask).sum() / mask.sum().clamp_min(1.0)


Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``adamw`` with its default betas (0.9, 0.999) and eps 1e-8;
    ``lr`` a constant or a schedule of the update count."""

    lr: Union[float, Schedule] = 1e-4
    weight_decay: float = 0.01

    def lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def init(self, params: Params) -> torch.optim.AdamW:
        return torch.optim.AdamW(list(leaves(params)), lr=self.lr_at(0), betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=self.weight_decay)


class TrainState(NamedTuple):
    params: Params                 # leaves that require grad, updated in place
    opt_state: torch.optim.AdamW   # its moments and counts
    step: int


def leaves(params: Params):
    """The tree's tensors, in a fixed order."""
    for key in sorted(params):
        value = params[key]
        if isinstance(value, dict):
            yield from leaves(value)
        else:
            yield value


def map_tree(fn, tree: Params) -> Params:
    return {k: map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def make_optimizer(lr: Union[float, Schedule] = 1e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay)


def make_train_step(cfg: WhisperConfig, optimizer: AdamW):
    """``train_step(state, mel, tokens, token_mask) -> (state, loss)``: one
    forward and backward, then one AdamW update at the schedule's value for
    the updates done so far."""

    def train_step(state: TrainState, mel, tokens, token_mask):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, mel, tokens, token_mask, cfg)
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = optimizer.lr_at(state.step)
        opt.step()
        return TrainState(state.params, opt, state.step + 1), loss.detach()

    return train_step


def init_train_state(params: Params, optimizer: AdamW) -> TrainState:
    """A state over copies of ``params`` that require grad (the model's own
    tensors stay as they are, as JAX's arrays do)."""
    trainable = map_tree(lambda t: t.detach().clone().requires_grad_(True), params)
    return TrainState(params=trainable, opt_state=optimizer.init(trainable), step=0)
