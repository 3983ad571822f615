"""K4 (``csrc/cross_attention_int8.cu``) against variants of its design and
at every cluster size: a probe for tuning the kernel, read by nothing else.

    python3 -m whisper_tpu_torch.utils.k4_variants   # repository root, one CUDA card

Builds the kernel as it is and as variants made by textual edits of copies
of ``csrc/`` under ``build/variants/`` (``tests/test_torch_int8_kernels.py``
checks on the CPU that every edit still finds its text in the source):

- ``loads_only``: each block issues its copies, waits for them and leaves
  (no output: what the copies alone cost);
- ``no_loads`` and, on top of it, without the logits pass, the P.V pass,
  or the cluster (barriers as block barriers, pushes kept local) (wrong
  numbers: what each costs).

At the cross memory's decode shapes (large-v3: q (64, 20, 1, 64) bf16 and
f32, and the beam fold (32, 20, 5, 64) bf16, over 1500 keys) it times each
at ``RANKS`` (the cluster sizes ``cross_attention_int8_plan`` may be given)
with CUDA events, twice in turns, and prints the largest error against the
plain version. The "as built" rows are the cluster-size readings from which
``KEYS_PER_RANK`` and ``KEYS_PER_RANK_ROWS`` were chosen.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import torch

from ..kernels import build
from ..kernels import cross_attention_int8 as k4
from ..model.quant import quantize_kv

# Ablations, each a list of textual edits of the source; a variant applies
# one or more of them.
_LOADS = [("if (n > 0) issue_rows(kt", "if (n < 0) issue_rows(kt"),
          ("if (n > 0) issue_rows(vt", "if (n < 0) issue_rows(vt")]
_LOGITS = [("  if (aligned) {\n    logits_pass", "  if (n < 0) {\n    logits_pass"),
           ("  } else {\n    logits_pass", "  } else if (n < 0) {\n    logits_pass")]
_PV = [("  if constexpr (ROWS == 1) {\n    if (aligned) {\n      pv_pass_row",
        "  if constexpr (ROWS == 0) {\n    if (aligned) {\n      pv_pass_row"),
       ("  } else {\n    if (aligned) {\n      pv_pass_rows",
        "  } else if (ROWS < 0) {\n    if (aligned) {\n      pv_pass_rows")]
_CLUSTER = [("cluster.map_shared_rank(mx, lane)", "mx"), ("cluster.map_shared_rank(sm, lane)", "sm"),
            ("cluster.map_shared_rank(in, d / per)", "in"),
            ('asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");', ""),
            ('asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");', ""),
            ("  cluster.sync();\n  if (warp == 0) {  // the global max",
             "  __syncthreads();\n  if (warp == 0) {  // the global max"),
            ("  cluster.sync();\n  if (warp == 0) {  // the global sum",
             "  __syncthreads();\n  if (warp == 0) {  // the global sum"),
            ("  cluster.sync();  // the last barrier", "  __syncthreads();  // the last barrier")]
VARIANTS = {
    "as built": [],
    "loads_only": [("  cp_async_wait<1>();\n  __syncthreads();\n",
                    "  cp_async_wait<0>();\n  __syncthreads();\n  if (n >= 0) return;\n")],
    "no_loads": _LOADS,
    "no_loads_logits": _LOADS + _LOGITS,
    "no_loads_pv": _LOADS + _PV,
    "no_loads_cluster": _LOADS + _CLUSTER,
}
CASES = [("cross", 64, 1, torch.bfloat16), ("cross-f32", 64, 1, torch.float32),
         ("cross-beam5", 32, 5, torch.bfloat16)]
RANKS = (2, 3, 4, 6, 8)
OUT = build.BUILD_DIR.parent / "variants"


def variant_source(name: str) -> str:
    """The kernel's source with variant ``name``'s edits applied; raises if
    an edit does not find its text exactly once."""
    text = (build.CSRC / "cross_attention_int8.cu").read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} not found once")
        text = text.replace(old, new)
    return text


def _build_all() -> dict:
    """Edited copies of csrc/, one nvcc each, all started together."""
    procs = {}
    for name in VARIANTS:
        src = OUT / f"k4_{name.replace(' ', '_')}"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC, src)
        path = src / "cross_attention_int8.cu"
        path.write_text(variant_source(name))
        lib = src / "libcross_attention_int8.so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{err}")
        fn = ctypes.CDLL(str(lib)).whisper_attention_int8
        fn.argtypes = k4._entry().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _time(fn, iters: int = 50) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    fns = _build_all()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for case, bsz, tq, dtype in CASES:
        q = (torch.randn(bsz, 20, tq, 64, device="cuda", generator=gen) * 0.3).to(dtype)
        k8, ks = quantize_kv(torch.randn(bsz, 20, 64, 1500, device="cuda", generator=gen))
        v8, vs = quantize_kv(torch.randn(bsz, 20, 64, 1500, device="cuda", generator=gen))
        ref = k4.cross_attention_int8_reference(q, k8, ks, v8, vs).float()
        for ranks in RANKS:
            plan = k4.cross_attention_int8_plan(1500, tq, None, ranks)
            outs, calls = {}, {}
            for name, fn in fns.items():
                out = torch.empty_like(q)
                outs[name] = out

                def call(fn=fn, out=out):
                    err = fn(q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
                             vs.data_ptr(), out.data_ptr(), bsz, 20, tq, 1500, k8.stride(0),
                             ks.stride(0), -1, None, k4._rows_per_block(tq, 1500), plan.ranks,
                             plan.chunk, int(dtype == torch.bfloat16),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"variant launch failed: cudaError {err}")
                calls[name] = call
            times = {name: [] for name in fns}
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    times[name].append(_time(calls[name]))
            for name in fns:
                err = (outs[name].float() - ref).abs().max().item()
                print(f"[k4-variants] {case} {ranks} ranks of {plan.chunk} keys, {name}: "
                      f"{sum(times[name]) / 2:.4f} ms ({times[name][0]:.4f}, "
                      f"{times[name][1]:.4f}); max_abs_err {err:.3e}; {card}", flush=True)


if __name__ == "__main__":
    main()
