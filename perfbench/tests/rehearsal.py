"""A cell's whole run at a tiny size on the CPU through the internal entry
(``cell.CellRun``): Whisper tiny (openai's preset: d_model 384, 6 heads,
4 + 4 layers, 80 mels) or ``WIDE``, a small slot pool and short windows.
The kernels run their plain versions."""

from __future__ import annotations

import copy
import time

import torch

from perfbench import run as R
from perfbench.cell import CellRun

TINY = dict(n_vocab=51865, n_audio_ctx=1500, n_state=384, n_head=6, n_audio_layer=4,
            n_text_ctx=448, n_text_layer=4, n_mels=80)
# large-v3's width (d_model 1280, 20 heads) on two layers each side: the
# control's gaps grow with the width of the logits (at tiny's 384 they
# stay near the limit, which is set from large-v3 on the card)
WIDE = dict(TINY, n_state=1280, n_head=20, n_audio_layer=2, n_text_layer=2)
SEED = 2 ** 31 + 12345  # past 32 signed bits, as the driver's seeds are


def small_cell(name: str) -> tuple:
    """BENCHMARK.json, the cell's file shrunk to a CPU run, and its
    configuration."""
    spec = R.load_spec()
    cell, config = R.load_files(name)
    cell = copy.deepcopy(cell)
    cell["engine"].update(slots=4, max_new_tokens=24, chunk_steps=4)
    cell["traffic"]["outstanding"] = 8
    cell["check"].update(min_tokens=60, max_requests=4)
    return spec, cell, config


def rehearse(name: str, seconds: float = 3.0, trace: bool = False, control: bool = False,
             seed: int = SEED, dims: dict = TINY) -> tuple:
    torch.set_num_threads(2)
    spec, cell, config = small_cell(name)
    out = CellRun(cell, config, seed, seconds, trace, "cpu", time.perf_counter(), dims=dims,
                  control=control).run()
    return spec, cell, out
