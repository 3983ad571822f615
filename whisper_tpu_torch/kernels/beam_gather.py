"""Row copies of the beam KV cache: the row gather (K6) and the in-place
copy-on-write fork copy (K7), with their plain PyTorch versions.

Port of ``whisper_tpu/kernels/beam_gather.py``:

  * ``permute_rows_multi(leaves, rows)``: ``[leaf[rows] for leaf in leaves]``
    along axis 0, every leaf in one launch (``permute_rows`` for one leaf,
    ``permute_cache_rows`` for a ``KVCache``). The host beam reorders its
    cache with it.
  * ``cow_copy_rows(leaves, src)``: in place, ``leaf[i] <- leaf[src[i]]``
    where ``src[i] != i``, every leaf in one launch. The device beam's fork
    copy. ``src`` must satisfy the copy-on-write invariant that no source
    row is also a destination row (``decoding.device_beam.cow_assign``
    guarantees it); the kernel does not check it, the plain version does.

Leaves are batch-leading and contiguous and may differ in dtype and trailing
shape (int8 codes (B, L, H, D, C) beside f32 scales (B, L, H, C), or bf16/f32
K and V). On CUDA tensors the wrappers launch ``csrc/beam_gather.cu``; on CPU
tensors they run the plain versions. There is no other route. Both kernels
follow ``copy_plan``: one block per real piece (a ``CHUNK_BYTES`` span of
one row of one leaf), leaf by leaf and chunk by chunk with the rows
innermost, so the copies of one source chunk run together.

``lane_dot_permute``/``layer_dot_permute`` (XLA carry-layout workarounds of
the JAX package) are not carried over.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from ..model.quant import QuantKV

MAX_LEAVES = 8
CHUNK_BYTES = 131072  # bytes per block; csrc/beam_gather.cu's CHUNK


def copy_plan(row_bytes: Sequence[int], n_rows: int) -> List[int]:
    """The launch plan of both row-copy kernels: the first block of each
    leaf, and the number of blocks in all last. With C = ``CHUNK_BYTES``,
    leaf z takes ``ceil(row_bytes[z] / C) * n_rows`` blocks; its block
    ``first[z] + c * n_rows + j`` copies bytes ``[c * C, min((c + 1) * C,
    row_bytes[z]))`` of row j, so no block is empty and the rows of one
    chunk are adjacent."""
    first = [0]
    for rb in row_bytes:
        first.append(first[-1] + -(-rb // CHUNK_BYTES) * n_rows)
    return first


def plan_pieces(row_bytes: Sequence[int], n_rows: int):
    """``(leaf, row, byte start, byte end)`` of every block of
    ``copy_plan``, in block order: what the kernels compute from their
    block index."""
    first = copy_plan(row_bytes, n_rows)
    for z, rb in enumerate(row_bytes):
        for b in range(first[z + 1] - first[z]):
            c, j = divmod(b, n_rows)
            yield z, j, c * CHUNK_BYTES, min((c + 1) * CHUNK_BYTES, rb)


def cache_leaves(cache) -> List[torch.Tensor]:
    """The tensors of a ``KVCache`` (float or ``QuantKV`` halves), in order."""
    out = []
    for half in cache:
        out.extend(half if isinstance(half, QuantKV) else [half])
    return out


def _rebuild(cache, leaves):
    """A cache of ``cache``'s type and structure over new leaves."""
    it = iter(leaves)
    halves = [QuantKV(next(it), next(it)) if isinstance(half, QuantKV) else next(it)
              for half in cache]
    return type(cache)(*halves)


def permute_rows_reference(leaves: Sequence[torch.Tensor],
                           rows: torch.Tensor) -> List[torch.Tensor]:
    """``index_select`` per leaf."""
    return [a.index_select(0, rows) for a in leaves]


def cow_copy_rows_reference(leaves: Sequence[torch.Tensor],
                            src: torch.Tensor) -> List[torch.Tensor]:
    """``leaf[dst] = leaf[src[dst]]`` over the rows where ``src[i] != i``,
    in place, after checking that no source row is a destination row."""
    rows = torch.arange(src.shape[0], device=src.device)
    dst = rows[src != rows]
    if torch.isin(src[dst], dst).any():
        raise ValueError("cow_copy_rows: a source row is also a destination row")
    for a in leaves:
        a[dst] = a[src[dst]]
    return list(leaves)


def _device_type(leaves, idx: torch.Tensor, what: str) -> str:
    """The device type shared by every leaf and the indices; the route is
    chosen by it, so a CPU index beside CUDA leaves raises."""
    if not leaves:
        raise ValueError(f"{what} takes 1 to {MAX_LEAVES} leaves, got 0")
    device = leaves[0].device
    for t in (*leaves, idx):
        if t.device != device:
            raise ValueError(f"{what}: a tensor is on {t.device}, the first leaf on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {device}")
    return device.type


def _check(leaves, idx: torch.Tensor, n_src: int, what: str) -> None:
    if not 1 <= len(leaves) <= MAX_LEAVES:
        raise ValueError(f"{what} takes 1 to {MAX_LEAVES} leaves, got {len(leaves)}")
    for a in leaves:
        if a.dim() < 1 or a.shape[0] != n_src:
            raise ValueError(f"{what}: every leaf needs {n_src} rows, got {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{what}: leaves must be contiguous")
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: indices must be 1-D int32/int64, got {idx.dtype} "
                         f"{tuple(idx.shape)}")


_PTRS, _SIZES = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong)
_ARGTYPES = {  # the C signatures in csrc/beam_gather.cu
    "whisper_permute_rows": [_PTRS, _PTRS, _SIZES, _SIZES, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_void_p],
    "whisper_cow_copy_rows": [_PTRS, _SIZES, _SIZES, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p],
}


@functools.cache
def _library() -> ctypes.CDLL:
    from .build import load_library

    lib = load_library("beam_gather")
    lib.whisper_row_copy_chunk_bytes.restype = ctypes.c_longlong
    if lib.whisper_row_copy_chunk_bytes() != CHUNK_BYTES:
        raise RuntimeError("csrc/beam_gather.cu's CHUNK differs from CHUNK_BYTES")
    return lib


def _launch(name: str, *args) -> None:
    fn = getattr(_library(), name)
    fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _sizes(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*values)


def _plan_args(leaves, n_rows: int):
    """(row bytes, copy_plan) of the leaves as C arrays."""
    row_bytes = [a[0].numel() * a.element_size() if a.shape[0] else 0 for a in leaves]
    return _sizes(row_bytes), _sizes(copy_plan(row_bytes, n_rows))


def permute_rows_multi(leaves: Sequence[torch.Tensor], rows: torch.Tensor) -> List[torch.Tensor]:
    """``[leaf[rows] for leaf in leaves]`` along axis 0, out of place, in one
    launch on CUDA. ``rows`` (int32/int64, on the leaves' device) may repeat
    a source and must be in range: the kernel does not check it.
    ``permute_rows_multi.launches`` counts kernel launches."""
    leaves = list(leaves)
    if _device_type(leaves, rows, "permute_rows_multi") == "cpu":
        return permute_rows_reference(leaves, rows)
    _check(leaves, rows, leaves[0].shape[0], "permute_rows_multi")
    rows = rows.to(torch.int64)
    outs = [torch.empty((rows.shape[0],) + a.shape[1:], dtype=a.dtype, device=a.device)
            for a in leaves]
    with torch.cuda.device(rows.device):
        _launch("whisper_permute_rows", _pointers(leaves), _pointers(outs),
                *_plan_args(leaves, rows.shape[0]), len(leaves), rows.data_ptr(), rows.shape[0],
                torch.cuda.current_stream(rows.device).cuda_stream)
    permute_rows_multi.launches += 1
    return outs


def permute_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``x[rows]`` for a single (B, ...) tensor (see ``permute_rows_multi``)."""
    return permute_rows_multi([x], rows)[0]


def permute_cache_rows(cache, rows: torch.Tensor):
    """Every leaf of a ``KVCache`` (float or ``QuantKV``) gathered by row
    in one launch; returns a new cache of the same structure."""
    return _rebuild(cache, permute_rows_multi(cache_leaves(cache), rows))


def cow_copy_rows(leaves: Sequence[torch.Tensor], src: torch.Tensor) -> List[torch.Tensor]:
    """In place: ``leaf[i] <- leaf[src[i]]`` wherever ``src[i] != i``, for
    every leaf, in one launch on CUDA; rows with ``src[i] == i`` are left
    untouched by the kernel itself, so the caller needs no identity check.

    ``src`` must satisfy the copy-on-write invariant (no source row is a
    destination row) and be in range; the kernel does not check either (the
    plain version checks the first). The launch stays on the current stream
    with no synchronise, so a following append into the same cache sees the
    copies. Returns the leaves. ``cow_copy_rows.launches`` counts launches."""
    leaves = list(leaves)
    if _device_type(leaves, src, "cow_copy_rows") == "cpu":
        return cow_copy_rows_reference(leaves, src)
    _check(leaves, src, src.shape[0], "cow_copy_rows")
    src = src.to(torch.int64)
    with torch.cuda.device(src.device):
        _launch("whisper_cow_copy_rows", _pointers(leaves), *_plan_args(leaves, src.shape[0]),
                len(leaves), src.data_ptr(), src.shape[0],
                torch.cuda.current_stream(src.device).cuda_stream)
    cow_copy_rows.launches += 1
    return leaves


permute_rows_multi.launches = 0
cow_copy_rows.launches = 0
