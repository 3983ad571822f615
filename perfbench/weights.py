"""Random weights drawn from the seed, on the device, in the serving dtype.

A family (``perfbench/families/<family>.py``) gives the tree of shapes,
keyed and laid out as its program reads the parameters, and the rule that
says how each leaf is filled: ``"normal"`` (drawn at ``scale``), ``"ones"``
or ``"zeros"``. Only the drawn leaves move the generator. One call a leaf,
in the sorted order of their paths, from one generator on the device, so
the same seed and configuration give the same tensors on every run. The
benchmark hands the same tree to the program and, drawn again after the
window, to the reference.
"""

from __future__ import annotations

from typing import Callable

import torch


@torch.no_grad()
def draw(shapes: dict, kind: Callable[[str], str], seed: int, dtype: torch.dtype, device,
         scale: float = 0.02) -> dict:
    """The tree of ``shapes`` from ``seed``, each leaf filled as ``kind(key)``
    says, directly in ``dtype``."""
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

    return fill(shapes)
