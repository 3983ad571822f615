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


def check_not_quantized(params: Params) -> None:
    """The int8/W8A8 weight forms (``*_scale`` keys, fused QKV) come with the
    port of model/quant.py; until then they are refused, not misread."""
    for part in ("encoder", "decoder"):
        tree = dict(params[part], **params[part]["blocks"])
        odd = sorted(k for k in tree if k.endswith("_scale") or k.startswith("qkv_"))
        if odd:
            raise NotImplementedError(
                f"quantized {part} weights ({', '.join(odd)}) are not ported yet")


def register_weights(module: nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Attach tensors to a module as buffers (moved by ``.to``, not trained)."""
    for name, t in tensors.items():
        module.register_buffer(name, t, persistent=False)
