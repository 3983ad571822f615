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
RUNS = {  # what -> (the command's arguments after python3, the lines kept)
    "main": (["-c", MAIN], ("[main] run", "[int8-main] run", "NVIDIA")),
    "k4": (["-c", K4], ("[k4]", "NVIDIA")),
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
