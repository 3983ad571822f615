"""Typed errors of the GGML loader, audio ingestion and the memory guard.

The port's own copy of the classes it raises from ``whisper_tpu/errors.py``:
one exception type per load/parse failure, so callers can match on them.
"""

from __future__ import annotations


class WhisperError(Exception):
    """Base class of the port's errors."""


class BadMagicError(WhisperError):
    """Model file does not start with the GGML magic."""

    def __init__(self, path: str, magic: int):
        super().__init__(f"invalid model file {path!r} (bad magic: 0x{magic:08x})")
        self.path = path
        self.magic = magic


class UnknownTensorError(WhisperError):
    """Checkpoint contains a tensor name not in the model schema."""

    def __init__(self, name: str):
        super().__init__(f"unknown tensor {name!r} in model file")
        self.name = name


class WrongSizeTensorError(WhisperError):
    """Tensor element count mismatch."""

    def __init__(self, name: str, got: int, expected: int):
        super().__init__(
            f"tensor {name!r} has wrong size in model file, got:{got}, expected:{expected}"
        )
        self.name = name
        self.got = got
        self.expected = expected


class WrongShapeTensorError(WhisperError):
    """Tensor shape mismatch."""

    def __init__(self, name: str, got, expected):
        super().__init__(
            f"tensor {name!r} has wrong shape in model file, got:{got}, expected:{expected}"
        )
        self.name = name
        self.got = tuple(got)
        self.expected = tuple(expected)


class WrongBytesTensorError(WhisperError):
    """Tensor byte count mismatch."""

    def __init__(self, name: str, got: int, expected: int):
        super().__init__(
            f"tensor {name!r} has wrong bytes in model file, got:{got}, expected:{expected}"
        )
        self.name = name
        self.got = got
        self.expected = expected


class TruncatedFileError(WhisperError):
    """Model file ended mid-record."""


class UnsupportedFtypeError(WhisperError):
    """Tensor record carries a ggml ftype other than f32 (0) or f16 (1)."""

    def __init__(self, name: str, ftype: int):
        super().__init__(
            f"tensor {name!r} has unsupported ggml ftype {ftype} "
            "(whisper.cpp-1.0.3 files are f32/f16 only)")
        self.name = name
        self.ftype = ftype


class AudioError(WhisperError):
    """WAV/PCM ingestion failure."""


class HbmBudgetError(WhisperError):
    """A serving configuration's device-memory estimate exceeds the card's
    budget (``config.check_serving_hbm``). Raised before any weight, pool or
    cache is allocated, so an oversized (batch, beam, dtype) combination
    fails with this message instead of running out of memory mid-step."""

    def __init__(self, what: str, estimate: dict, budget_bytes: int,
                 batch: int = 0, beam: int = 1):
        gb = 2**30
        terms = ", ".join(f"{k} {v / gb:.2f}" for k, v in estimate.items()
                          if k != "total")
        super().__init__(
            f"{what} needs ~{estimate['total'] / gb:.2f} GB of device memory "
            f"(batch={batch}, beam={beam}; {terms} GB) but only "
            f"{budget_bytes / gb:.2f} GB is budgeted — reduce batch/beam or "
            f"quantize the KV pools (int8)")
        self.what = what
        self.estimate = estimate
        self.budget_bytes = budget_bytes
        self.batch = batch
        self.beam = beam
