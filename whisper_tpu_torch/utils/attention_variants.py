"""The split-TF32 attention kernels against variants of their design choices.

    python3 -m whisper_tpu_torch.utils.attention_variants   # repository root, one CUDA card

Builds the f32 forward (``csrc/flash_attention.cu``) and the K1c backward
(``csrc/flash_attention_bwd.cu``) as they are and as variants made by
textual edits of copies of ``csrc/`` under ``build/variants/``:

- ``cvt``: hi and lo both rounded by ``cvt.rna.tf32.f32``;
- ``swizzle``: unpadded 64-float tile rows with an XOR swizzle of the
  columns (``c ^ 4 (r & 7)``) in place of rows padded to 68 floats;
- ``fwd_k32``: 32-key forward tiles;
- ``fwd_one_block``: the forward built for one 256-thread block an SM.

At the training path's (40, 1500, 64) f32 it times each forward and
backward with CUDA events, twice in turns, and prints each one's largest
error against an f64 truth beside that of the plain versions (cuBLAS f32,
TF32 off). Variants are loaded side by side: the kernels' symbols have
internal linkage.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import torch

from ..kernels import build
from ..kernels import flash_attention as fa

VARIANTS = {
    "as built": {},
    "cvt": {
        "attention_tf32.cuh": [
            ("return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
             'uint32_t y;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));\n  return y;'),
            ("lo[i] = __float_as_uint(__fsub_rn(x[i], __uint_as_float(hi[i])));",
             "lo[i] = round_tf32(__fsub_rn(x[i], __uint_as_float(hi[i])));")]},
    "swizzle": {
        "attention_tf32.cuh": [
            ("constexpr int LD = D + 4;", "constexpr int LD = D;"),
            ("return r * LD + c;", "return r * D + (c ^ ((r & 7) << 2));")]},
    "fwd_k32": {"attention_tf32.cuh": [("FWD_K = 64,", "FWD_K = 32,")]},
    "fwd_one_block": {
        "attention_tf32.cuh": [("__launch_bounds__(FWD_THREADS, 2)",
                                "__launch_bounds__(FWD_THREADS, 1)")]},
}
OUT = build.BUILD_DIR.parent / "variants"


def _build(name: str, edits: dict) -> tuple:
    src = OUT / name.replace(" ", "_")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC, src)
    for fname, pairs in edits.items():
        text = (src / fname).read_text()
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} not found once in {fname}")
            text = text.replace(old, new)
        (src / fname).write_text(text)
    procs = [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(src / f"lib{n}.so"),
                               str(src / f"{n}.cu")], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for n in ("flash_attention", "flash_attention_bwd")]
    for p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{err}")
    fwd = ctypes.CDLL(str(src / "libflash_attention.so")).whisper_flash_attention
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    bwd = ctypes.CDLL(str(src / "libflash_attention_bwd.so")).whisper_flash_attention_bwd
    bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def main() -> None:
    import chip_smoke as smoke  # the device checks and the timer

    card = smoke.phase_device()
    kernels = {name: _build(name, edits) for name, edits in VARIANTS.items()}
    bh, t = 40, 1500
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn(bh, t, 64, device="cuda", generator=gen) for _ in range(4))
    q64, k64, v64 = (x.double().requires_grad_() for x in (q, k, v))
    o64 = torch.softmax(q64 @ k64.transpose(-1, -2) / 8, -1) @ v64
    truth = (o64.detach(), *torch.autograd.grad(o64, (q64, k64, v64), g.double()))
    del q64, k64, v64, o64

    def errors(values) -> str:
        return ", ".join(f"{n} {(a.double() - b).abs().max().item():.2e}"
                         for n, a, b in zip(("out", "dq", "dk", "dv"), values, truth))

    out, lse = fa.flash_attention_lse_reference(q, k, v)
    print(f"[variants] plain f32 (cuBLAS, TF32 off) against f64: "
          f"{errors((out, *fa.flash_sdpa_backward(q, k, v, out, lse, g, False)))}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for turn in range(2):
        for name, (fwd, bwd) in kernels.items():
            o, l = torch.empty_like(q), torch.empty(bh, t, device="cuda")
            dq, dk, dv, delta = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
                                 torch.empty(bh, t, device="cuda"))

            def run_fwd():
                return fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(),
                           bh, t, t, 0, 0, 0.125, stream)

            def run_bwd():
                return bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
                           l.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                           dv.data_ptr(), bh, t, t, 0, 0, 0.125, stream)

            if run_fwd() or run_bwd():
                raise RuntimeError(f"variant {name!r}: launch failed")
            torch.cuda.synchronize()
            err = errors((o, dq, dk, dv))
            fwd_ms, bwd_ms = smoke.cuda_ms(run_fwd, 20), smoke.cuda_ms(run_bwd, 20)
            print(f"[variants] turn {turn + 1}, {name}: forward {fwd_ms:.4f} ms, backward "
                  f"{bwd_ms:.4f} ms at ({bh}, {t}, 64) f32; against f64: {err}; {card}",
                  flush=True)


if __name__ == "__main__":
    main()
