"""Random Whisper weights drawn from the seed, on the device, in the serving
dtype and in the parameter layout the program reads: a nested dict whose
per-layer tensors are stacked along a leading layer axis.

Every drawn tensor is normal at ``scale`` (0.02); layer-norm weights are one
and biases zero, so only the drawn leaves move the generator. One call a
stacked leaf (about forty in all), in a fixed order, so the same seed and
configuration give the same tensors on every run. The benchmark hands the
same tree to the program and, drawn again after the window, to the
reference.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_ENC_BLOCK = ("attn_ln_w", "attn_ln_b", "q_w", "q_b", "k_w", "v_w", "v_b", "out_w", "out_b",
              "mlp_ln_w", "mlp_ln_b", "mlp0_w", "mlp0_b", "mlp1_w", "mlp1_b")
_DEC_BLOCK = _ENC_BLOCK + ("cross_attn_ln_w", "cross_attn_ln_b", "cross_q_w", "cross_q_b",
                           "cross_k_w", "cross_v_w", "cross_v_b", "cross_out_w", "cross_out_b")


def dims(config: dict) -> Dict[str, int]:
    """The sizes the harness uses, from a configuration file's published
    Hugging Face keys."""
    p = config["published"]
    if p["encoder_attention_heads"] != p["decoder_attention_heads"]:
        raise ValueError("Whisper uses one head count in both stacks")
    if p["encoder_ffn_dim"] != 4 * p["d_model"] or p["decoder_ffn_dim"] != 4 * p["d_model"]:
        raise ValueError("Whisper's MLP is 4 x d_model wide")
    return {"n_vocab": p["vocab_size"], "n_audio_ctx": p["max_source_positions"],
            "n_state": p["d_model"], "n_head": p["encoder_attention_heads"],
            "n_audio_layer": p["encoder_layers"], "n_text_ctx": p["max_target_positions"],
            "n_text_layer": p["decoder_layers"], "n_mels": p["num_mel_bins"]}


def _block_shape(name: str, n_layer: int, a: int) -> Tuple[int, ...]:
    base = name[len("cross_"):] if name.startswith("cross_") else name
    if base in ("q_w", "k_w", "v_w", "out_w"):
        return (n_layer, a, a)
    if base == "mlp0_w":
        return (n_layer, 4 * a, a)
    if base == "mlp0_b":
        return (n_layer, 4 * a)
    if base == "mlp1_w":
        return (n_layer, a, 4 * a)
    return (n_layer, a)


def shapes(d: Dict[str, int]) -> dict:
    """The tree of shapes, keyed as the program's parameter tree."""
    a = d["n_state"]
    return {
        "encoder": {
            "pe": (d["n_audio_ctx"], a), "conv1_w": (a, d["n_mels"], 3), "conv1_b": (a,),
            "conv2_w": (a, a, 3), "conv2_b": (a,), "ln_post_w": (a,), "ln_post_b": (a,),
            "blocks": {k: _block_shape(k, d["n_audio_layer"], a) for k in _ENC_BLOCK},
        },
        "decoder": {
            "pe": (d["n_text_ctx"], a), "te": (d["n_vocab"], a), "ln_w": (a,), "ln_b": (a,),
            "blocks": {k: _block_shape(k, d["n_text_layer"], a) for k in _DEC_BLOCK},
        },
    }


def kind(name: str) -> str:
    """How a leaf is filled: "ones" for layer-norm weights, "zeros" for
    biases, "normal" for the rest."""
    if name.endswith("ln_w") or name == "ln_post_w":
        return "ones"
    if name.endswith("_b"):
        return "zeros"
    return "normal"


@torch.no_grad()
def draw(d: Dict[str, int], seed: int, dtype: torch.dtype, device, scale: float = 0.02) -> dict:
    """The weight tree of ``d`` from ``seed``: one generator on ``device``,
    leaves drawn in the sorted order of their paths, directly in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))

    def fill(tree: dict) -> dict:
        out = {}
        for key in sorted(tree):
            spec = tree[key]
            if isinstance(spec, dict):
                out[key] = fill(spec)
                continue
            how = kind(key)
            if how == "normal":
                out[key] = torch.randn(spec, generator=gen, device=device, dtype=dtype).mul_(scale)
            else:
                out[key] = (torch.ones if how == "ones" else torch.zeros)(spec, dtype=dtype,
                                                                          device=device)
        return out

    return fill(shapes(d))
