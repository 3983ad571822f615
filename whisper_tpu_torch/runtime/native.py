"""ctypes bindings for the native C++ host runtime (``native/whisper_rt.cc``).

The port's own copy of ``whisper_tpu/runtime/native.py``: WAV decode,
zero-copy (mmap) GGML checkpoint parsing and a threaded WAV prefetcher, in
C++ on the host, so that model load and audio ingest do not wait on Python
loops. No device work goes through this layer.

The library is built on first use with g++ from the port's own source into
``build/native/libwhisper_rt-<hash>.so`` at the repository root (the hash
covers the source and the flags, so an edit rebuilds), never into the
package tree. When the build or the load fails, the callers take the
pure-Python readers of ``io``: every read is counted in ``reads`` under the
reader that ran, and the fallback is logged once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.logging import get_logger

log = get_logger("native")

SOURCE = Path(__file__).resolve().parent / "native" / "whisper_rt.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")

# Reads by reader: "ggml-native", "ggml-python", "wav-native", "wav-python".
reads: Dict[str, int] = {}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def count(kind: str) -> None:
    reads[kind] = reads.get(kind, 0) + 1


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libwhisper_rt-{h.hexdigest()[:16]}.so"


def build(out: Optional[Path] = None) -> Path:
    """Compile the library with g++ into ``out`` (``library_path()`` by
    default); raises RuntimeError when the compiler fails or is missing."""
    out = out or library_path()
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the native runtime")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The library, built if needed; None (logged once) when it cannot be
    built or loaded."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            log.warning("native runtime unavailable, the Python readers run instead: %s", e)
            return None
        _configure(lib)
        _lib = lib
        log.info("native runtime loaded from %s", path)
        return _lib


def _configure(lib: ctypes.CDLL) -> None:
    lib.wrt_load_wav.restype = ctypes.c_void_p
    lib.wrt_load_wav.argtypes = [ctypes.c_char_p]
    lib.wrt_wav_rate.restype = ctypes.c_int
    lib.wrt_wav_rate.argtypes = [ctypes.c_void_p]
    lib.wrt_wav_len.restype = ctypes.c_longlong
    lib.wrt_wav_len.argtypes = [ctypes.c_void_p]
    lib.wrt_wav_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.wrt_wav_data.argtypes = [ctypes.c_void_p]
    lib.wrt_wav_free.restype = None
    lib.wrt_wav_free.argtypes = [ctypes.c_void_p]

    lib.wrt_open_ggml.restype = ctypes.c_void_p
    lib.wrt_open_ggml.argtypes = [ctypes.c_char_p]
    lib.wrt_ggml_error.restype = ctypes.c_char_p
    lib.wrt_ggml_error.argtypes = [ctypes.c_void_p]
    lib.wrt_ggml_header.restype = ctypes.POINTER(ctypes.c_int)
    lib.wrt_ggml_header.argtypes = [ctypes.c_void_p]
    lib.wrt_ggml_filters.restype = ctypes.POINTER(ctypes.c_float)
    lib.wrt_ggml_filters.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int)]
    lib.wrt_ggml_n_vocab.restype = ctypes.c_int
    lib.wrt_ggml_n_vocab.argtypes = [ctypes.c_void_p]
    lib.wrt_ggml_token.restype = ctypes.POINTER(ctypes.c_char)
    lib.wrt_ggml_token.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.wrt_ggml_n_tensors.restype = ctypes.c_int
    lib.wrt_ggml_n_tensors.argtypes = [ctypes.c_void_p]
    lib.wrt_ggml_tensor_name.restype = ctypes.c_char_p
    lib.wrt_ggml_tensor_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.wrt_ggml_tensor_info.restype = None
    lib.wrt_ggml_tensor_info.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),     # ftype
        ctypes.POINTER(ctypes.c_int),     # n_dims
        ctypes.POINTER(ctypes.c_int),     # ne[4]
        ctypes.POINTER(ctypes.c_void_p),  # data pointer
    ]
    lib.wrt_ggml_close.restype = None
    lib.wrt_ggml_close.argtypes = [ctypes.c_void_p]

    lib.wrt_loader_open.restype = ctypes.c_void_p
    lib.wrt_loader_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                    ctypes.c_int]
    lib.wrt_loader_get.restype = ctypes.c_void_p
    lib.wrt_loader_get.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.wrt_loader_close.restype = None
    lib.wrt_loader_close.argtypes = [ctypes.c_void_p]


def available() -> bool:
    return _load() is not None


def _take_wav(lib: ctypes.CDLL, h) -> Tuple[int, np.ndarray]:
    """(rate, mono f32 PCM) of a decoded WAV handle, which it frees."""
    try:
        n = lib.wrt_wav_len(h)
        audio = np.ctypeslib.as_array(lib.wrt_wav_data(h), shape=(n,)).copy()
        return lib.wrt_wav_rate(h), audio
    finally:
        lib.wrt_wav_free(h)


def native_load_wav(path: str) -> Optional[Tuple[int, np.ndarray]]:
    """WAV decode by the C++ runtime: (rate, mono f32 PCM), or None when the
    runtime is unavailable or cannot read the file."""
    lib = _load()
    if lib is None:
        return None
    h = lib.wrt_load_wav(path.encode())
    if not h:
        return None
    count("wav-native")
    return _take_wav(lib, h)


def native_open_ggml(path: str):
    """mmap-backed GGML parse by the C++ runtime: (header list, filters,
    tokens as bytes, {name: array copied out of the mapping}), or None when
    the runtime is unavailable. A malformed file raises RuntimeError with the
    runtime's message."""
    lib = _load()
    if lib is None:
        return None
    h = lib.wrt_open_ggml(path.encode())
    if not h:
        return None
    try:
        err = lib.wrt_ggml_error(h)
        if err:
            raise RuntimeError(err.decode())
        hdr = lib.wrt_ggml_header(h)
        header = [hdr[i] for i in range(11)]
        n_mel, n_fft = ctypes.c_int(), ctypes.c_int()
        fptr = lib.wrt_ggml_filters(h, ctypes.byref(n_mel), ctypes.byref(n_fft))
        filters = np.ctypeslib.as_array(fptr, shape=(n_mel.value, n_fft.value)).copy()
        tokens = []
        tlen = ctypes.c_int()
        for i in range(lib.wrt_ggml_n_vocab(h)):
            tp = lib.wrt_ggml_token(h, i, ctypes.byref(tlen))
            tokens.append(ctypes.string_at(tp, tlen.value))
        tensors = {}
        ftype, ndims = ctypes.c_int(), ctypes.c_int()
        ne = (ctypes.c_int * 4)()
        dptr = ctypes.c_void_p()
        for i in range(lib.wrt_ggml_n_tensors(h)):
            name = lib.wrt_ggml_tensor_name(h, i).decode()
            lib.wrt_ggml_tensor_info(h, i, ctypes.byref(ftype), ctypes.byref(ndims), ne,
                                     ctypes.byref(dptr))
            shape = tuple(reversed([ne[d] for d in range(ndims.value)]))
            dt = np.dtype(np.float32 if ftype.value == 0 else np.float16)
            buf = (ctypes.c_char * (int(np.prod(shape)) * dt.itemsize)).from_address(dptr.value)
            tensors[name] = np.frombuffer(buf, dtype=dt).reshape(shape).copy()
        count("ggml-native")
        return header, filters, tokens, tensors
    finally:
        lib.wrt_ggml_close(h)


class NativeAudioLoader:
    """Threaded WAV prefetcher over the C++ runtime: worker threads decode
    (and downmix) files in the background while the caller consumes them in
    submission order. Without the runtime it decodes synchronously with the
    Python reader.

    >>> for idx, rate, audio in NativeAudioLoader(paths, n_threads=4):
    ...     submit(audio)
    """

    def __init__(self, paths, n_threads: int = 4):
        self.paths = list(paths)
        self._lib = _load()
        self._h = None
        if self._lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self._h = self._lib.wrt_loader_open(arr, len(self.paths), int(n_threads))

    def get(self, index: int) -> Optional[Tuple[int, np.ndarray]]:
        """(rate, mono f32 PCM) of file ``index``, blocking until it is
        decoded; None when the file cannot be read."""
        if self._h is None:
            from ..io.wav import load_wav

            return 16000, load_wav(self.paths[index])
        w = self._lib.wrt_loader_get(self._h, index)
        if not w:
            return None
        count("wav-native")
        return _take_wav(self._lib, w)

    def __iter__(self):
        for i in range(len(self.paths)):
            item = self.get(i)
            if item is not None:
                yield (i, item[0], item[1])

    def close(self) -> None:
        if getattr(self, "_h", None) is not None:
            self._lib.wrt_loader_close(self._h)
            self._h = None

    def __del__(self):  # noqa: D105
        self.close()
