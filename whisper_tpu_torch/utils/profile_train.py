"""torch.profiler breakdown of one fine-tuning step (large-v3, f32, batch 2).

    python3 -m whisper_tpu_torch.utils.profile_train   # repository root, one CUDA card

Draws a random large-v3 in f32 on the card (``random_model``), makes
chip_smoke.py's training batch (two synthetic 30 s clips with 40-token
transcripts, a 64-token bucket), runs two warm train steps at lr 1e-4 and
profiles a third: the forward, the backward (K1c's closed form included)
and the AdamW update. It prints the wall time, the device time, the busy
share and the largest device items, as ``profile_int8`` does, and the op
table goes to ``build/profile/profile_train_step.txt``.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

from .profile_int8 import report


def main() -> None:
    import chip_smoke as smoke  # the device checks and the synthetic pairs

    from ..kernels import build
    from ..model.load import random_model
    from ..training.finetune import make_batches
    from ..training.train import init_train_state, make_optimizer, make_train_step

    card = smoke.phase_device()
    build.build_all(smoke.KERNELS)
    cfg = smoke.PRESETS["large-v3"]
    model = random_model(cfg, seed=0, dtype=torch.float32, device="cuda")
    batch = next(make_batches(model, smoke.train_pairs(2, 300), 2))
    optimizer = make_optimizer(1e-4)
    state = init_train_state(model.params, optimizer)
    step = make_train_step(cfg, optimizer)
    for _ in range(2):
        state, loss = step(state, *batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, *batch)
        loss = loss.item()  # waits for the step
        wall = time.perf_counter() - t0
    print(f"[profile] train step 3 loss {loss:.6f}", flush=True)
    report("train_step", prof, wall, card)


if __name__ == "__main__":
    main()
