"""Parameters: the JAX package's parameter tree as tensors on one device.

``params_from_ggml`` (numpy; the port's own copy of the JAX package's)
assembles the GGML tensors into a nested dict with every per-layer weight
stacked along a leading layer axis. The port keeps that layout, so both
packages compute from identical numbers; the encoder and decoder modules
take per-layer views of the stacked tensors. ``random_params`` (numpy,
JAX's draws) and ``random_params_device`` (torch, on the device) build
random trees in the same layout.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch
from torch import nn

from ..config import WhisperConfig
from ..io.ggml import tensor_schema
from .quant import _ENC_WEIGHT_KEYS

Params = Dict[str, Any]

# (tree field -> ggml name suffix) for one encoder block.
_ENC_BLOCK = {
    "attn_ln_w": "attn_ln.weight",
    "attn_ln_b": "attn_ln.bias",
    "q_w": "attn.query.weight",
    "q_b": "attn.query.bias",
    "k_w": "attn.key.weight",
    "v_w": "attn.value.weight",
    "v_b": "attn.value.bias",
    "out_w": "attn.out.weight",
    "out_b": "attn.out.bias",
    "mlp_ln_w": "mlp_ln.weight",
    "mlp_ln_b": "mlp_ln.bias",
    "mlp0_w": "mlp.0.weight",
    "mlp0_b": "mlp.0.bias",
    "mlp1_w": "mlp.2.weight",
    "mlp1_b": "mlp.2.bias",
}

# One decoder block adds cross-attention.
_DEC_BLOCK = dict(
    _ENC_BLOCK,
    **{
        "cross_attn_ln_w": "cross_attn_ln.weight",
        "cross_attn_ln_b": "cross_attn_ln.bias",
        "cross_q_w": "cross_attn.query.weight",
        "cross_q_b": "cross_attn.query.bias",
        "cross_k_w": "cross_attn.key.weight",
        "cross_v_w": "cross_attn.value.weight",
        "cross_v_b": "cross_attn.value.bias",
        "cross_out_w": "cross_attn.out.weight",
        "cross_out_b": "cross_attn.out.bias",
    },
)


def _assemble(t: Callable[[str], Any], stack: Callable, config: WhisperConfig) -> Params:
    """The model tree from ``t(ggml name)`` (one tensor, already in its
    dtype), each per-layer weight stacked by ``stack`` along a leading
    layer axis; numpy arrays and torch tensors alike."""
    c = config

    def blocks(prefix: str, n_layer: int, block_map: Dict[str, str]):
        return {field: stack([t(f"{prefix}.{i}.{suffix}") for i in range(n_layer)])
                for field, suffix in block_map.items()}

    return {
        "encoder": {
            "pe": t("encoder.positional_embedding"),
            "conv1_w": t("encoder.conv1.weight"),
            "conv1_b": t("encoder.conv1.bias").reshape(-1),
            "conv2_w": t("encoder.conv2.weight"),
            "conv2_b": t("encoder.conv2.bias").reshape(-1),
            "ln_post_w": t("encoder.ln_post.weight"),
            "ln_post_b": t("encoder.ln_post.bias"),
            "blocks": blocks("encoder.blocks", c.n_audio_layer, _ENC_BLOCK),
        },
        "decoder": {
            "pe": t("decoder.positional_embedding"),
            "te": t("decoder.token_embedding.weight"),
            "ln_w": t("decoder.ln.weight"),
            "ln_b": t("decoder.ln.bias"),
            "blocks": blocks("decoder.blocks", c.n_text_layer, _DEC_BLOCK),
        },
    }


def params_from_ggml(tensors: Dict[str, np.ndarray], config: WhisperConfig,
                     dtype=np.float32) -> Params:
    """Assemble the named GGML tensors into the model tree (numpy)."""
    return _assemble(lambda name: tensors[name].astype(dtype), np.stack, config)


def params_to_ggml(params: Params, config: WhisperConfig) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_ggml``: the named GGML tensors (numpy f32 on
    the host) of a float tree of numpy arrays or tensors, for re-export with
    ``io.ggml.write_ggml``."""
    def host(x) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", torch.float32).numpy()
        return np.asarray(x)

    enc, dec = params["encoder"], params["decoder"]
    out: Dict[str, np.ndarray] = {
        "encoder.positional_embedding": host(enc["pe"]),
        "encoder.conv1.weight": host(enc["conv1_w"]),
        "encoder.conv1.bias": host(enc["conv1_b"]).reshape(-1, 1),
        "encoder.conv2.weight": host(enc["conv2_w"]),
        "encoder.conv2.bias": host(enc["conv2_b"]).reshape(-1, 1),
        "encoder.ln_post.weight": host(enc["ln_post_w"]),
        "encoder.ln_post.bias": host(enc["ln_post_b"]),
        "decoder.positional_embedding": host(dec["pe"]),
        "decoder.token_embedding.weight": host(dec["te"]),
        "decoder.ln.weight": host(dec["ln_w"]),
        "decoder.ln.bias": host(dec["ln_b"]),
    }
    for prefix, n_layer, block_map, blocks in (
        ("encoder.blocks", config.n_audio_layer, _ENC_BLOCK, enc["blocks"]),
        ("decoder.blocks", config.n_text_layer, _DEC_BLOCK, dec["blocks"]),
    ):
        for field, suffix in block_map.items():
            stacked = host(blocks[field])
            for i in range(n_layer):
                out[f"{prefix}.{i}.{suffix}"] = stacked[i]
    return out


def _random_kind(name: str) -> str:
    """How a random model fills a tensor: LN weights one, biases zero, the
    rest drawn."""
    if name.endswith(("ln.weight", "ln_post.weight")):
        return "ones"
    return "zeros" if name.endswith(".bias") else "normal"


RANDOM_SCALE = 0.02  # the standard deviation of a random model's drawn weights


def random_params(config: WhisperConfig, seed: int = 0, scale: float = RANDOM_SCALE) -> Params:
    """Random-weight tree (numpy) for tests and benchmarks: the JAX
    package's ``random_params``, the same numpy draws in the same order over
    ``tensor_schema``, so one seed gives its weights bit for bit."""
    rng = np.random.default_rng(seed)
    tensors = {}
    for name, (shape, _kind) in tensor_schema(config).items():
        kind = _random_kind(name)
        if kind == "normal":
            tensors[name] = rng.standard_normal(shape).astype(np.float32) * scale
        else:
            tensors[name] = (np.ones if kind == "ones" else np.zeros)(shape, dtype=np.float32)
    return params_from_ggml(tensors, config)


def random_params_device(config: WhisperConfig, seed: int, dtype: torch.dtype,
                         device: torch.device | str) -> Params:
    """``random_params``'s distribution drawn on ``device`` by a seeded
    ``torch.Generator``, tensor by tensor, so a large model needs no host
    staging. torch's draws, not numpy's: the values differ from
    ``random_params`` (as JAX's on-device draws differ from its numpy ones)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = {name: shape for name, (shape, _kind) in tensor_schema(config).items()}

    def draw(name: str) -> torch.Tensor:
        kind, shape = _random_kind(name), shapes[name]
        if kind == "normal":
            x = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * RANDOM_SCALE
            return x.to(dtype)
        return (torch.ones if kind == "ones" else torch.zeros)(shape, dtype=dtype, device=device)

    return _assemble(draw, torch.stack, config)


def params_to_torch(params: Params, device: torch.device | str,
                    dtype: torch.dtype) -> Params:
    """Convert a numpy pytree to tensors of ``dtype`` on ``device``, one leaf
    at a time: each bf16 tensor is rounded from its own f32 array, on the
    device, so the host never holds a second full-size copy."""
    return {
        key: (params_to_torch(leaf, device, dtype) if isinstance(leaf, dict)
              else torch.from_numpy(np.ascontiguousarray(leaf)).to(device=device).to(dtype))
        for key, leaf in params.items()
    }


def check_quantized(params: Params) -> None:
    """Each ``<name>_scale`` entry (``model.quant``) must scale an int8
    ``<name>``: a scale beside a float weight would be misread, so it raises.
    The encoder blocks are W8A8 in all six projections or in none."""
    for part in ("encoder", "decoder"):
        tree = dict(params[part], **params[part]["blocks"])
        for key in sorted(k for k in tree if k.endswith("_scale")):
            w = tree.get(key[:-len("_scale")])
            if w is None or w.dtype != torch.int8:
                raise ValueError(f"{part} {key} needs an int8 {key[:-len('_scale')]}, "
                                 f"got {None if w is None else w.dtype}")
    blocks = params["encoder"]["blocks"]
    n_scaled = sum(name + "_scale" in blocks for name in _ENC_WEIGHT_KEYS)
    if n_scaled not in (0, len(_ENC_WEIGHT_KEYS)):
        raise ValueError(f"encoder blocks have scales for {n_scaled} of the "
                         f"{len(_ENC_WEIGHT_KEYS)} projections {_ENC_WEIGHT_KEYS}: W8A8 needs all")


def register_weights(module: nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Attach tensors to a module as buffers (moved by ``.to``, not trained)."""
    for name, t in tensors.items():
        module.register_buffer(name, t, persistent=False)
