"""Run the main paths of two checkouts' chip_smoke.py in turns on one card.

    python3 -m whisper_tpu_torch.utils.compare_trees PARENT CHANGE   # one CUDA card

Each tree's own chip_smoke.py runs its phases 1, 2, 5 and 8 (device, build,
the bf16 batch-8 transcription and the int8 batch-64 serving step, each run
twice, the second warm) in a fresh process, in the order parent, change,
change, parent, so that two versions are compared on one card within one
call. Both trees read one synthetic checkpoint: PARENT's build/synthetic
becomes a link to CHANGE's. Prints each process's run lines under its tree.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

PHASES = """
import chip_smoke as c
card = c.phase_device()
c.phase_build()
_, model = c.phase_main_path(card)
c.phase_int8_main_path(card, model)
"""
KEEP = ("[main] run", "[int8-main] run", "[build] 5 kernels", "NVIDIA")


def main(parent: str, change: str) -> None:
    parent_root, change_root = Path(parent).resolve(), Path(change).resolve()
    shared = change_root / "build" / "synthetic"
    shared.mkdir(parents=True, exist_ok=True)
    link = parent_root / "build" / "synthetic"
    if not link.exists():
        link.parent.mkdir(parents=True, exist_ok=True)
        link.symlink_to(shared, target_is_directory=True)
    for name, root in (("parent", parent_root), ("change", change_root),
                       ("change", change_root), ("parent", parent_root)):
        proc = subprocess.run([sys.executable, "-c", PHASES], cwd=root, capture_output=True,
                              text=True)
        for line in proc.stdout.splitlines():
            if line.startswith(KEEP):
                print(f"[{name}] {line}", flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"{name} ({root}) failed:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    main(sys.argv[1], sys.argv[2])
