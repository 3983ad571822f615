"""Run the same measurement on two checkouts in turns on one card.

    python3 -m whisper_tpu_torch.utils.compare_trees PARENT CHANGE [WHAT]   # one CUDA card

WHAT is one of:
- ``main`` (the default): each tree's own chip_smoke.py runs its phases 1,
  2, 5 and 8 (device, build, the bf16 batch-8 transcription and the int8
  batch-64 serving step, each run twice, the second warm);
- ``k4``: each tree's own K4 (``cross_attention_int8``) at the decode
  shapes (large-v3 cross memory at batch 64 with one query row and with the
  3-token prompt, the beam fold at 32 x 5 rows, a self-cache layer of 75
  positions at n_past 40), bf16, on the same seeded inputs: CUDA-event time
  through the wrapper and in a CUDA graph;
- ``k5``: each tree's own K5 (``cached_attention``) at the bf16 decode
  shapes (phase 5's greedy step at batch 8 over 104 positions and its
  32-token prefill, phase 12's host beam step over 448 positions and its
  3-token prompt), on the same seeded inputs: CUDA-event time through the
  wrapper and in a CUDA graph;
- ``fq``: each tree's own fused_quant (K2 "act", K3 "ln" and "gelu") at
  the b64 int8 encode's shapes, and "act" at gelu's (96000, 5120), which
  moves gelu's bytes, bf16, on the same seeded inputs, timed in the same
  two ways;
- ``profile_int8``: each tree's ``utils.profile_int8`` (the int8 encode,
  decode16 and beam16 under torch.profiler).

Each runs in a fresh process, in the order parent, change, change, parent,
so that two versions are compared on one card within one call. Both trees
read one synthetic checkpoint: PARENT's build/synthetic becomes a link to
CHANGE's. Prints each process's result lines under its tree.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

MAIN = """
import chip_smoke as c
card = c.phase_device()
c.phase_build()
_, model = c.phase_main_path(card)
c.phase_int8_main_path(card, model)
"""
K4 = """
import torch
import chip_smoke as c
from whisper_tpu_torch.kernels.cross_attention_int8 import cross_attention_int8
from whisper_tpu_torch.model.quant import quantize_kv
card = c.phase_device()
c.phase_build()
gen = torch.Generator(device="cuda").manual_seed(1)
for name, bsz, tq, keys, n_past in (("cross", 64, 1, 1500, None), ("cross-t3", 64, 3, 1500, None),
                                    ("cross-beam5", 32, 5, 1500, None), ("self", 64, 1, 75, 40)):
    q = (torch.randn(bsz, 20, tq, 64, device="cuda", generator=gen) * 0.3).to(torch.bfloat16)
    (k8, ks), (v8, vs) = (quantize_kv(torch.randn(bsz, 20, 64, keys, device="cuda", generator=gen))
                          for _ in range(2))
    call = lambda: cross_attention_int8(q, k8, ks, v8, vs, n_past)
    print(f"[k4] {name} q ({bsz}, 20, {tq}, 64) over {keys} keys, n_past {n_past}: kernel "
          f"{c.cuda_ms(call, 50):.4f} ms, in a CUDA graph {c.graph_ms(call, 50):.4f} ms; {card}",
          flush=True)
"""
K5 = """
import torch
import chip_smoke as c
from whisper_tpu_torch.kernels.decode_attention import cached_attention
card = c.phase_device()
c.phase_build()


def graph20(fn):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            fn()
    return c.cuda_ms(graph.replay, 50) / 20


gen = torch.Generator(device="cuda").manual_seed(2)
for name, bsz, tq, ctx, n_past in (("b8", 8, 1, 104, 40), ("b8-prefill", 8, 32, 104, 0),
                                   ("beam", 20, 1, 448, 40), ("beam-t3", 20, 3, 448, 0)):
    q = (torch.randn(bsz, 20, tq, 64, device="cuda", generator=gen) * 0.5).to(torch.bfloat16)
    kc, vc = (torch.randn(bsz, 4, 20, 64, ctx, device="cuda", generator=gen).to(torch.bfloat16)
              for _ in range(2))
    call = lambda: cached_attention(q, kc[:, 2], vc[:, 2], n_past)
    print(f"[k5] {name} q ({bsz}, 20, {tq}, 64) over {ctx} positions, n_past {n_past}: "
          f"through the wrapper {c.cuda_ms(call, 500):.4f} ms, in a CUDA graph "
          f"{c.graph_ms(call, 500):.4f} ms, 20 calls in one graph {graph20(call):.4f} ms a call; "
          f"{card}", flush=True)
one = torch.zeros(1, device="cuda")
print(f"[k5] floor: one elementwise kernel (add_ on one element) in a CUDA graph "
      f"{c.graph_ms(lambda: one.add_(1), 500):.4f} ms, 20 in one graph "
      f"{graph20(lambda: one.add_(1)):.4f} ms a kernel; {card}", flush=True)
"""
FQ = r"""
import re
import subprocess
from pathlib import Path
import torch
import chip_smoke as c
from whisper_tpu_torch.kernels import build, fused_quant as fq
card = c.phase_device()
c.phase_build()
gen = torch.Generator(device="cuda").manual_seed(1)
for name, n, d in (("act", 96000, 1280), ("ln", 96000, 1280), ("gelu", 96000, 5120),
                   ("act-5120", 96000, 5120)):
    x = (torch.randn(n, d, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    w, b = (torch.randn(d, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(2))
    call = {"act": lambda: fq.act_quant(x), "ln": lambda: fq.ln_quant(x, w, b),
            "gelu": lambda: fq.gelu_quant(x, "erf")}[name.split("-")[0]]
    print(f"[fq] {name} ({n}, {d}) bf16: through the wrapper {c.cuda_ms(call, 20):.4f} ms, "
          f"in a CUDA graph {c.graph_ms(call, 20):.4f} ms; {card}", flush=True)
    del x
# static SASS of the bf16 kernels: instructions, and those on the special
# function unit (MUFU) and the FMA pipe
lib = build._library_path("fused_quant")
sass = subprocess.run([str(Path(build._nvcc()).with_name("cuobjdump")), "-sass", str(lib)],
                      capture_output=True, text=True, check=True).stdout
for func in re.split(r"\n\s*Function : ", sass)[1:]:
    name, body = func.split("\n", 1)
    if "nv_bfloat16" not in name:
        continue
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
    print(f"[fq] sass {name[name.find('kernelI') + 7:].strip()[:32]}: {len(ops)} instructions, "
          f"{sum(o.startswith('MUFU') for o in ops)} MUFU, "
          f"{sum(o.split('.')[0] in ('FFMA', 'FMUL', 'FADD') for o in ops)} FFMA/FMUL/FADD", flush=True)
"""
RUNS = {  # what -> (the command's arguments after python3, the lines kept)
    "main": (["-c", MAIN], ("[main] run", "[int8-main] run", "NVIDIA")),
    "k4": (["-c", K4], ("[k4]", "NVIDIA")),
    "k5": (["-c", K5], ("[k5]", "NVIDIA")),
    "fq": (["-c", FQ], ("[fq]", "NVIDIA")),
    "profile_int8": (["-m", "whisper_tpu_torch.utils.profile_int8"], ("[profile]", "NVIDIA")),
}


def main(parent: str, change: str, what: str = "main") -> None:
    args, keep = RUNS[what]
    parent_root, change_root = Path(parent).resolve(), Path(change).resolve()
    shared = change_root / "build" / "synthetic"
    shared.mkdir(parents=True, exist_ok=True)
    link = parent_root / "build" / "synthetic"
    if not link.exists():
        link.parent.mkdir(parents=True, exist_ok=True)
        link.symlink_to(shared, target_is_directory=True)
    for name, root in (("parent", parent_root), ("change", change_root),
                       ("change", change_root), ("parent", parent_root)):
        proc = subprocess.run([sys.executable, *args], cwd=root, capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith(keep):
                print(f"[{name}] {line}", flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"{name} ({root}) failed:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")


if __name__ == "__main__":
    if len(sys.argv) not in (3, 4) or sys.argv[3:4] and sys.argv[3] not in RUNS:
        raise SystemExit(__doc__)
    main(*sys.argv[1:])
