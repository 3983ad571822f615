"""Decode-step self-attention over the float KV cache (K5) and its plain version.

Port of ``whisper_tpu/kernels/decode_attention.py`` (``cached_attention`` ->
``_cached_attn_kernel``), with the numerics of the path the JAX package
runs at that site, ``model/decoder._kvmajor_sdpa``: f32 scores times
D^-0.5, -1e30 on masked keys, f32 softmax, and the normalised probabilities
rounded to the cache's dtype before the PV sum (the Pallas kernel keeps them
in f32). The kernel reads one layer of the port's batch-leading
(B, L, H, D, C) cache in place, through its batch stride; it needs neither
the TPU kernel's layer-leading layout nor its 128-padded context.

``n_past`` is an int shared by every row, or a (B,) int32 tensor on the
device with each row's own position (the serving engine's slots): the
kernel then reads row b's position in device memory, the launch plan is
sized for the whole cache, and each block still reads only its row's
visible keys. The plain version takes the same tensor, under a
(B, 1, T, C) mask.

On a CUDA tensor ``cached_attention`` launches ``csrc/decode_attention.cu``;
on a CPU tensor it runs ``cached_attention_reference``. There is no other
route: a CUDA call that the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .build import launch_on, load_library
from .ops import NEG

D_HEAD = 64
SMEM_MAX = 232448  # the 227 KB of shared memory a block may take
_SMEM_LIMIT = 200 * 1024  # what a block's q rows and logits may take of it
_FLOATS = (torch.float32, torch.bfloat16)


class K5Plan(NamedTuple):
    """A launch of K5: a block per (b, h) and ``rows`` query rows
    (``row_blocks`` blocks along T), K and V walked in tiles of ``width``
    keys through two slots of 64 rows of ``pitch`` bytes; ``smem`` bytes a
    block."""

    rows: int
    row_blocks: int
    width: int
    pitch: int
    smem: int


def _layout(rows: int, c_max: int, width: int, esz: int) -> tuple:
    """(pitch, shared-memory bytes) of a block, as ``layout`` in
    ``csrc/decode_attention.cu``: [rows][64] q and [rows][c_max] logits in
    f32, then two slots of 64 rows, each ``width`` keys and up to 15 bytes of
    shift, padded to 16 mod 128 bytes."""
    pitch = (width * esz + 30) // 16 * 16
    pitch += (144 - pitch % 128) % 128
    floats = rows * D_HEAD + rows * (-(-c_max // 4) * 4)
    return pitch, -(-floats * 4 // 16) * 16 + 2 * D_HEAD * pitch


@functools.lru_cache(maxsize=4096)
def cached_attention_plan(c_len: int, tq: int, n_past: int, esz: int) -> K5Plan:
    """How K5 covers a call over ``c_len`` positions with ``tq`` query rows
    at ``n_past`` and a cache of ``esz``-byte elements: the fewest of 1, 2,
    4, 8 rows a block that hold min(tq, 8), halved while the q rows and the
    logits of every visible key (min(c_len, n_past + tq)) pass 200 KB; then
    K and V in one tile each when both fit the rest of 227 KB, else in tiles
    of the most keys (a multiple of 16) that do. Raises for a call that does
    not fit."""
    c_max = min(c_len, n_past + tq)
    rows = 1
    while rows < min(tq, 8):
        rows *= 2
    while rows > 1 and 4 * rows * (D_HEAD + c_max) > _SMEM_LIMIT:
        rows //= 2
    if 4 * rows * (D_HEAD + c_max) > _SMEM_LIMIT:
        raise ValueError(f"cached_attention takes at most {_SMEM_LIMIT // 4 - D_HEAD} "
                         f"visible positions, got {c_max}")
    width = c_max
    while _layout(rows, c_max, width, esz)[1] > SMEM_MAX:
        width = (width - 1) // 16 * 16
        if width == 0:
            raise ValueError(f"cached_attention over {c_max} visible positions does not fit "
                             f"{SMEM_MAX} bytes of shared memory")
    pitch, smem = _layout(rows, c_max, width, esz)
    return K5Plan(rows, -(-tq // rows), width, pitch, smem)


def tile_pieces(head: int, c_len: int, c0: int, n: int, esz: int, row: int) -> list:
    """The copies that bring keys [c0, c0 + n) of row ``row`` of a head into
    its slot row, as ``issue_tile`` in ``csrc/decode_attention.cu`` makes
    them: (global byte, bytes, slot-row byte, "async" or "element") for each
    16-byte piece from the row's aligned start, a piece across the head's
    bounds (``head`` is its first byte; 64 rows of ``c_len`` elements)
    taken one needed element at a time."""
    lo, hi = head, head + D_HEAD * c_len * esz
    a = lo + (row * c_len + c0) * esz
    e = a + n * esz
    out = []
    for piece in range((n * esz + 30) // 16):
        p = (a & ~15) + 16 * piece
        if p >= e:
            continue
        if p >= lo and p + 16 <= hi:
            out.append((p, 16, 16 * piece, "async"))
        else:
            out += [(s, esz, 16 * piece + s - p, "element")
                    for s in range(max(p, a), min(p + 16, e), esz)]
    return out


def _kvmajor_sdpa(q, k, v, mask: Optional[torch.Tensor], scale: float):
    """softmax(q kᵀ * scale, masked) v with f32 scores and softmax.

    q (B,H,T,D) head-split; k/v (B,H,D,C) kv-major; mask bool (T,C)
    broadcastable, True = attend, or None for all keys. The normalised
    probabilities round to v's dtype; the result has q's dtype."""
    logits = torch.matmul(q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float().transpose(-1, -2)).to(q.dtype)


def causal_mask(n_past, t: int, c: int, device) -> torch.Tensor:
    """Key ``c`` is seen by query ``t`` iff c <= n_past + t: (T, C) bool for
    an int ``n_past``, (B, 1, T, C) for a (B,) tensor of each row's own."""
    key_pos = torch.arange(c, device=device)
    q_pos = torch.arange(t, device=device)[:, None]
    if isinstance(n_past, torch.Tensor):
        return key_pos <= n_past.reshape(-1, 1, 1, 1) + q_pos
    return key_pos[None, :] <= n_past + q_pos


def cached_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               n_past) -> torch.Tensor:
    """``_kvmajor_sdpa`` over (B,H,T,D) q and one (B,H,D,C) cache layer,
    with the causal mask at ``n_past`` (an int, or a (B,) tensor)."""
    mask = causal_mask(n_past, q.shape[-2], k.shape[-1], q.device)
    return _kvmajor_sdpa(q, k, v, mask, q.shape[-1] ** -0.5)


def _check(q, k, v) -> None:
    if q.dtype not in _FLOATS or k.dtype not in _FLOATS:
        raise TypeError(f"cached_attention takes float32 or bfloat16, got q {q.dtype}, "
                        f"cache {k.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if v.dtype != k.dtype:
        raise TypeError(f"k is {k.dtype}, v is {v.dtype}")
    if q.dim() != 4 or q.shape[-1] != D_HEAD or q.shape[2] == 0:
        raise ValueError(f"q must be (B, H, T>0, {D_HEAD}), got {tuple(q.shape)}")
    B, H = q.shape[:2]
    C = k.shape[-1]
    if k.shape != (B, H, D_HEAD, C) or v.shape != k.shape or C == 0:
        raise ValueError(f"k/v must be ({B}, {H}, {D_HEAD}, C>0), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    # Each batch row contiguous; the batch stride is free (a cache layer slice).
    if k.stride()[1:] != (D_HEAD * C, C, 1) or v.stride() != k.stride():
        raise ValueError(f"k/v need strides (any, {D_HEAD * C}, {C}, 1), alike, "
                         f"got {k.stride()}, {v.stride()}")


def check_rows(n_past: torch.Tensor, q: torch.Tensor, who: str) -> None:
    """A per-row ``n_past`` must be a contiguous (B,) int32 tensor on q's
    device: the kernels read it there. Its values are never read on the host
    (each must be >= 0)."""
    if (n_past.dtype != torch.int32 or n_past.shape != (q.shape[0],)
            or n_past.device != q.device or not n_past.is_contiguous()):
        raise ValueError(f"{who}: a per-row n_past must be a contiguous ({q.shape[0]},) int32 "
                         f"tensor on {q.device}, got {n_past.dtype} {tuple(n_past.shape)} on "
                         f"{n_past.device}")


@functools.cache
def _entry():
    """The kernel's C entry point, resolved and typed once per process."""
    fn = load_library("decode_attention").whisper_cached_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_past) -> torch.Tensor:
    """softmax(q kᵀ · D^-0.5, causal at ``n_past``) v over (B,H,T,64) q and
    one kv-major (B,H,64,C) layer of the float cache (f32 or bf16, the batch
    stride free); the result has q's dtype. ``n_past`` is an int, or a (B,)
    int32 tensor on q's device with each row's own position (the engine's
    slots), which the kernel reads in device memory. On the card the launch
    follows ``cached_attention_plan``, sized for the whole cache when
    ``n_past`` is a tensor. ``cached_attention.launches`` counts kernel
    launches, ``.ragged_launches`` those with a tensor ``n_past``."""
    if q.device.type == "cpu":
        return cached_attention_reference(q, k, v, n_past)
    if q.device.type != "cuda":
        raise ValueError(f"cached_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    B, H, T, _ = q.shape
    C = k.shape[-1]
    rows = None
    if isinstance(n_past, torch.Tensor):
        check_rows(n_past, q, "cached_attention")
        rows, n_past = n_past.data_ptr(), max(0, C - T)
    elif n_past < 0:
        raise ValueError(f"n_past must be >= 0, got {n_past}")
    plan = cached_attention_plan(C, T, n_past, k.element_size())
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, T, C, k.stride(0),
            n_past, rows, D_HEAD ** -0.5, plan.rows, plan.width, int(q.dtype == torch.bfloat16),
            int(k.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    err = launch_on(q.device, _entry(), *args)
    if err != 0:
        raise RuntimeError(f"cached_attention kernel launch failed: cudaError {err}")
    cached_attention.launches += 1
    cached_attention.ragged_launches += rows is not None
    return out


cached_attention.launches = 0
cached_attention.ragged_launches = 0
