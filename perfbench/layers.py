"""The arithmetic of the per-layer metrics. Each reads a run's record:

  ``window_s``   the measured window's length (host clock);
  ``stats``      ``engine.stats`` over the window (admit_s, chunk_s, pull_s,
                 rounds, windows, requests);
  ``launches``   kernel launch counts over the window;
  ``done``       the requests resolved in the window, with their results;
  ``host``       ``window_s``, ``stats``, ``done`` and ``encode_windows``
                 of the window less its profiled stretch, where the
                 host-clock metrics read;
  ``trace``      the profiled sub-window (``trace.DeviceTrace.reduce``) with
                 its own ``stats`` and ``launches``, and the windows
                 (``encode_windows``) and buckets (``encode_buckets``) the
                 engine installed there, or absent;
  ``dims``, ``cell``.

Each returns None where the record holds nothing to read.
"""

from __future__ import annotations

import re
from typing import Optional

from . import flops, served
from .roofline import PEAK_BF16_FLOPS, bound_s, share

K1_NAME = "attention_bf16_kernel"   # K1, encoder self-attention
K4_NAME = "attention_int8_kernel"   # K4, cross and self attention over int8


def admit_share(rec: dict) -> Optional[float]:
    """Percent of the window the worker spent admitting (mel, encode,
    prefill, install)."""
    h = rec["host"]
    if "admit_s" not in h["stats"] or h["window_s"] <= 0:
        return None
    return 100.0 * h["stats"]["admit_s"] / h["window_s"]


def step_ms(rec: dict) -> Optional[float]:
    """Host milliseconds a decode step, chunks and their pulls over the
    steps the rounds ran (rounds x chunk steps)."""
    s = rec["host"]["stats"]
    steps = s.get("rounds", 0) * rec["cell"]["engine"]["chunk_steps"]
    if steps <= 0:
        return None
    return 1000.0 * (s["chunk_s"] + s["pull_s"]) / steps


def idle_share(rec: dict) -> Optional[float]:
    """Percent of the traced sub-window with no kernel running."""
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["n_kernels"] == 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def request_flops(dims: dict, result: dict) -> float:
    """Model operations a resolved request needed: each of its windows
    encoded, its prompt prefilled and its committed tokens decoded."""
    sot_len = 3 if dims["n_vocab"] >= 51865 else 1
    total = 0.0
    for w in served.windows(result):
        prompt = served.initial_tokens(w["prompt"], [0] * sot_len, 0, dims["n_text_ctx"])
        total += flops.window_flops(dims, len(prompt), len(w["tokens"]))
    return total


def mfu(rec: dict) -> Optional[float]:
    """Percent of the chip's bf16 peak: the operations of the requests
    resolved in the window over the whole window. The window holds whole
    cycles of the engine's waves; a stretch of it (the profiled one) holds
    a part of a cycle, whose resolutions come in one burst."""
    if not rec["done"] or rec["window_s"] <= 0:
        return None
    work = sum(request_flops(rec["dims"], e["result"]) for e in rec["done"])
    return 100.0 * work / (rec["window_s"] * PEAK_BF16_FLOPS)


def _kernels(tr: dict, name: str) -> dict:
    """{template arguments: (launches, seconds)} of the traced kernels whose
    name holds ``name``."""
    out: dict = {}
    for k, sec in tr["kernel_s"].items():
        if name in k:
            m = re.search(re.escape(name) + r"<([^>]*)>", k)
            key = m.group(1) if m else ""
            n0, s0 = out.get(key, (0, 0.0))
            out[key] = (n0 + tr["kernel_n"][k], s0 + sec)
    return out


def _rows_a_bucket(tr: dict) -> Optional[float]:
    """The real windows an admission bucket held, on average, in the
    traced sub-window."""
    return tr["encode_windows"] / tr["encode_buckets"] if tr.get("encode_buckets") else None


def k1_roofline(rec: dict) -> Optional[float]:
    """K1's share of its bound over the traced sub-window: the windows the
    admission buckets encoded there (the real ones, not a bucket's padding
    rows), each needing every encoder layer's heads at (1500, 1500, 64),
    against the device time of the K1 launches the trace holds. A padded
    bucket's rows cost device time and count no work."""
    tr = rec.get("trace")
    if not tr or not tr.get("encode_windows"):
        return None
    d = rec["dims"]
    seconds = sum(s for _n, s in _kernels(tr, K1_NAME).values())
    if seconds <= 0:
        return None
    h, dh, t = d["n_head"], d["n_state"] // d["n_head"], d["n_audio_ctx"]
    bound = tr["encode_windows"] * d["n_audio_layer"] * bound_s(
        flops.k1_flops(h, t, t, dh), flops.k1_bytes(h, t, t, dh))
    return share(bound, seconds)


def _mean_self_keys(rec: dict) -> float:
    """The mean number of self keys a decode step reads a row, over the
    committed tokens of the windows resolved in the window."""
    d = rec["dims"]
    sot_len = 3 if d["n_vocab"] >= 51865 else 1
    keys = n = 0
    for e in rec.get("done") or []:
        for w in served.windows(e["result"]):
            p = len(served.initial_tokens(w["prompt"], [0] * sot_len, 0, d["n_text_ctx"]))
            t = len(w["tokens"])
            keys += t * p + t * (t + 1) // 2
            n += t
    return keys / n if n else 0.0


def k4_roofline(rec: dict) -> Optional[float]:
    """K4's share of its bound over the traced sub-window, from the trace's
    own K4 launches. A decode step launches K4 twice a layer with one query
    row (template row count 1): the cross over the whole slot pool (slots
    and the spare row) at 1500 keys and the self at each row's own keys
    (the mean over the resolved windows' prompts and tokens), as many of
    one as of the other. An admission launches it twice a layer over a
    bucket's prompt (more rows a block): the cross over the bucket's rows
    at 1500 keys and a short self, counted at its cross, for the real
    windows a bucket held."""
    tr = rec.get("trace")
    if not tr:
        return None
    d, eng = rec["dims"], rec["cell"]["engine"]
    h, dh, ta = d["n_head"], d["n_state"] // d["n_head"], d["n_audio_ctx"]
    rows = eng["slots"] + 1
    keys = _mean_self_keys(rec)
    bucket = _rows_a_bucket(tr) or 0.0
    b = f = seconds = 0.0
    for key, (n, sec) in _kernels(tr, K4_NAME).items():
        seconds += sec
        if key.endswith(" 1"):  # decode: cross and self alike
            b += n / 2 * (flops.k4_bytes(rows, h, 1, dh, ta) + flops.k4_bytes(rows, h, 1, dh, keys))
            f += n / 2 * (flops.k4_flops(rows, h, 1, dh, ta) + flops.k4_flops(rows, h, 1, dh, keys))
        else:  # admission prefill
            b += n / 2 * flops.k4_bytes(bucket, h, 1, dh, ta)
    return share(bound_s(f, b), seconds)
