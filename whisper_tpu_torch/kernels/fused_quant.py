"""Per-token int8 quantization fused with its producer (K2, K3) and the
plain PyTorch versions.

Port of ``whisper_tpu/kernels/fused_quant.py`` (``act_quant``, ``ln_quant``,
``gelu_quant`` -> ``_fused_kernel``). Each wrapper returns ``(y8, scale)``:
int8 codes (..., D) and the f32 per-token scale (..., 1), the contract of
``model.quant.quantize_act``. On a CUDA tensor it launches the kernel in
``csrc/fused_quant.cu`` (see the note there: a row in the registers of one
to eight warps, as ``fused_quant_plan`` says, read once in 16-byte vectors);
on a CPU tensor it runs the unfused chain the TPU kernel is held to,
``quantize_act(x)``, ``quantize_act(layer_norm(x, w, b))`` or
``quantize_act(gelu(x))``. There is no other route: a CUDA call that the
kernel cannot take raises.

The kernel's GELU uses the TPU kernel's Abramowitz-Stegun erf (max abs
error 1.5e-7) where the plain chain uses the exact erf, and its LN sums in
another order, so a code may differ from the plain version's by a level
at a rounding boundary; "act" is bit-exact.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..model.quant import quantize_act
from .build import launch_on, load_library
from .ops import gelu, layer_norm

_MODES = {"act": 0, "ln": 1, "gelu-erf": 2, "gelu-tanh": 3}
VECTOR = 8  # elements a thread loads at once: 16 bytes of bf16 (csrc: VEC)
VECTORS = 6  # vectors a thread holds (csrc: NV)
WARPS_PER_ROW = (1, 2, 4, 8)  # of the block's eight warps
_MAX_D = WARPS_PER_ROW[-1] * 32 * VECTOR * VECTORS  # 12288


class FQPlan(NamedTuple):
    """A launch of the fused_quant kernel: ``warps_per_row`` warps own a row
    (of a 256-thread block's eight); thread ``sub`` of a row holds
    ``vectors`` vectors of ``VECTOR`` elements, vector v being elements
    (v * 32 * warps_per_row + sub) * VECTOR onward; ``vector``: 16-byte
    loads and 8-byte stores, else the same elements one at a time."""

    warps_per_row: int
    vectors: int
    vector: bool


@functools.lru_cache(maxsize=256)
def fused_quant_plan(d: int, aligned: bool = True) -> FQPlan:
    """The fewest warps a row (1, 2, 4, 8) whose threads hold D elements in
    ``VECTORS`` vectors each; 16-byte vectors when D is a multiple of 8 and
    the inputs' bases are 16-byte ``aligned`` (csrc/fused_quant.cu checks
    the pointers itself)."""
    wpr = next((w for w in WARPS_PER_ROW if d <= w * 32 * VECTOR * VECTORS), None)
    if wpr is None or d < 1:
        raise ValueError(f"fused_quant takes 1 <= D <= {_MAX_D}, got {d}")
    return FQPlan(wpr, -(-d // (wpr * 32 * VECTOR)), aligned and d % VECTOR == 0)


def thread_elements(plan: FQPlan, d: int, sub: int) -> list:
    """The elements of a row that thread ``sub`` of the row holds, by vector:
    the kernel's layout, cut at D."""
    span = plan.warps_per_row * 32 * VECTOR
    return [list(range(v * span + sub * VECTOR, min(v * span + (sub + 1) * VECTOR, d)))
            for v in range(plan.vectors)]


def _check(x: torch.Tensor, *affine: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_quant takes float32 or bfloat16, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] == 0 or x.numel() == 0:
        raise ValueError(f"fused_quant needs a non-empty (..., D) tensor, got {tuple(x.shape)}")
    if x.shape[-1] > _MAX_D:
        raise ValueError(f"fused_quant takes D <= {_MAX_D}, got {x.shape[-1]}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for name, t in zip(("w", "b"), affine):
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape[-1:]:
            raise ValueError(f"{name} must be ({x.shape[-1]},) {x.dtype} on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _entry():
    """The kernel's C entry point, resolved and typed once per process."""
    fn = load_library("fused_quant").whisper_fused_quant
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(mode: str, x: torch.Tensor, w=None, b=None, eps: float = 0.0):
    if x.device.type != "cuda":
        raise ValueError(f"fused_quant runs on cpu or cuda, not {x.device}")
    affine = () if w is None else (w, b)
    _check(x, *affine)
    d = x.shape[-1]
    y8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), w.data_ptr() if w is not None else None,
            b.data_ptr() if b is not None else None, y8.data_ptr(), scale.data_ptr(),
            x.numel() // d, d, fused_quant_plan(d).warps_per_row, _MODES[mode],
            int(x.dtype == torch.bfloat16), eps, torch.cuda.current_stream(x.device).cuda_stream)
    err = launch_on(x.device, _entry(), *args)
    if err != 0:
        raise RuntimeError(f"fused_quant kernel ({mode}) launch failed: cudaError {err}")
    return y8, scale


def act_quant(x: torch.Tensor):
    """x -> (int8, per-token scale) in one read. ``act_quant.launches``
    counts kernel launches."""
    if x.device.type == "cpu":
        return quantize_act(x)
    out = _launch("act", x)
    act_quant.launches += 1
    return out


def ln_quant(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
    """LayerNorm(x) * w + b (f32 moments) -> (int8, per-token scale).
    ``ln_quant.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return quantize_act(layer_norm(x, w, b, eps))
    out = _launch("ln", x, w, b, eps)
    ln_quant.launches += 1
    return out


def gelu_quant(x: torch.Tensor, impl: str = "erf"):
    """gelu(x) ('erf' or 'tanh') -> (int8, per-token scale).
    ``gelu_quant.launches`` counts kernel launches."""
    if impl not in ("erf", "tanh"):
        raise ValueError(f"gelu impl must be 'erf' or 'tanh', got {impl!r}")
    if x.device.type == "cpu":
        return quantize_act(gelu(x, impl))
    out = _launch(f"gelu-{impl}", x)
    gelu_quant.launches += 1
    return out


act_quant.launches = 0
ln_quant.launches = 0
gelu_quant.launches = 0
