"""Parameters: the JAX package's numpy pytree as tensors on one device.

``whisper_tpu.model.params.params_from_ggml`` (numpy, no jax) assembles the
GGML tensors into a nested dict with every per-layer weight stacked along a
leading layer axis. The port keeps that layout, so both packages compute
from identical numbers; the encoder and decoder modules take per-layer
views of the stacked tensors.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .quant import _ENC_WEIGHT_KEYS

Params = Dict[str, Any]


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
