"""Typed errors of the GGML loader and of audio ingestion.

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
