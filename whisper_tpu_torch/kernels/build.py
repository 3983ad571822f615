"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain C interface, ``build/kernels/lib<name>-<hash>.so`` at the repository
root. The hash covers the sources and the compiler flags, so an edit
rebuilds; a library that exists is loaded as it is. The build needs ``nvcc``
and a CUDA device and raises without either: nothing here falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> (seconds spent in nvcc, or 0.0 when the library was cached;
#          ptxas resource report)
build_info: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
            nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return nvcc


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str, out: Path) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"cannot build CUDA kernel {name!r}: no CUDA device")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_info[name] = (time.perf_counter() - t0, proc.stderr.strip())


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _library_path(name)
            if out.exists():
                build_info.setdefault(name, (0.0, "cached"))
            else:
                _compile(name, out)
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
        return lib


def build_all(names) -> None:
    """Compile the kernels not built yet all at once, one nvcc process each,
    then load every one."""
    todo = {name: _library_path(name) for name in names}
    todo = {name: out for name, out in todo.items() if not out.exists()}
    if todo:
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            list(pool.map(_compile, todo, todo.values()))
    for name in names:
        load_library(name)


def launch_on(device: torch.device, entry, *args) -> int:
    """Call a kernel's C entry point with ``args`` on ``device`` (the stream
    among the args must be that device's), making the device current only
    when it is not: entering ``torch.cuda.device`` costs host time on every
    decode step. Returns the entry's cudaError_t."""
    if device.index == torch.cuda.current_device():
        return entry(*args)
    with torch.cuda.device(device):
        return entry(*args)
