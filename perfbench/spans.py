"""The program's own stages, read by the benchmark.

The engine's worker keeps its stages in ``engine.stats`` (seconds as
``<stage>_s``, and counters) and, while ``engine.spans.record(True)`` is on,
as spans on ``time.perf_counter_ns``: name, start, end, parent, request ids
(``whisper_tpu_torch.utils.logging.Span``).

- ``init_share``, ``harvest_share`` and ``decode_step_ms`` read the totals
  over the host window, as ``layers.admit_share`` reads ``admit_s``; they
  return None for a program that keeps no such total.
- ``clock_anchor`` and ``profiler_offset_us`` put the profiler's events on
  the spans' clock: the profiling thread enters a ``record_function`` block
  between two reads of ``perf_counter_ns``, and that block's event,
  matched to the reads' midpoint, gives the offset of one clock from the
  other.
- ``idle_in_stages`` puts each idle gap of the card, mapped so, down to the
  worker's stages: what the worker was doing while no kernel ran.
  ``label_gap`` names a gap by the innermost stage the worker was in.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

from torch.profiler import record_function

from .trace import merge_intervals

ANCHOR = "perfbench.clock_anchor"

# the worker's stages that own an idle gap of the card, by what they do
IDLE_STAGES = {
    "admit": ("server.start_request", "engine.admit"),
    "decode": ("engine.chunk", "engine.pull"),
    "harvest": ("engine.finish",),
}


def _host_share(rec: dict, key: str) -> Optional[float]:
    h = rec["host"]
    if key not in h["stats"] or h["window_s"] <= 0:
        return None
    return 100.0 * h["stats"][key] / h["window_s"]


def init_share(rec: dict) -> Optional[float]:
    """Percent of the window the worker spent starting requests
    (``server.start_request``: the clip's mel on the card, language
    detection)."""
    return _host_share(rec, "init_s")


def harvest_share(rec: dict) -> Optional[float]:
    """Percent of the window the worker spent on the finished windows
    after each pull (``engine.finish``: results, segments, resolving the
    futures with their done callbacks)."""
    return _host_share(rec, "harvest_s")


def decode_step_ms(rec: dict) -> Optional[float]:
    """Host milliseconds a decode step: the chunks and their pulls over the
    steps the chunks really ran (``decode_steps``)."""
    s = rec["host"]["stats"]
    if not s.get("decode_steps"):
        return None
    return 1000.0 * (s["chunk_s"] + s["pull_s"]) / s["decode_steps"]


def clock_anchor() -> int:
    """On the profiling thread, under a running profiler: a
    ``record_function`` block between two ``perf_counter_ns`` reads; their
    midpoint."""
    a = time.perf_counter_ns()
    with record_function(ANCHOR):
        pass
    b = time.perf_counter_ns()
    return (a + b) // 2


def profiler_offset_us(events, anchor_ns: int) -> Optional[float]:
    """``perf_counter`` microseconds less profiler microseconds, from the
    anchor's event; None where the profile holds none."""
    ev = next((e for e in events if e.name == ANCHOR), None)
    if ev is None:
        return None
    return anchor_ns / 1e3 - (ev.time_range.start + ev.time_range.end) / 2


def _overlap(a: Tuple[float, float], b: Tuple[float, float]) -> float:
    return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))


def _covered(a: list, b: list) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += _overlap(a[i], b[j])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_stages(gaps_us: Sequence[Tuple[float, float]], spans,
                   offset_us: float) -> Dict[str, float]:
    """Seconds of the idle ``gaps_us`` (sorted and disjoint, profiler
    microseconds) that fall inside each group of ``IDLE_STAGES``; the rest
    as ``"ingest"`` (in ``server.ingest``), ``"round"`` (in an
    ``engine.round`` but in none of its stages above) and ``"none"`` (in
    no recorded round). The stages of one round are disjoint on the
    worker's thread, so the parts sum to the gaps' total."""
    gaps = [(s + offset_us, t + offset_us) for s, t in gaps_us]

    def idle_in(names) -> float:
        inside = merge_intervals([(sp.start_ns / 1e3, sp.end_ns / 1e3) for sp in spans
                                  if sp.name in names])
        return _covered(gaps, inside) / 1e6

    out = {group: idle_in(names) for group, names in IDLE_STAGES.items()}
    out["ingest"] = idle_in(("server.ingest",))
    in_rounds = idle_in(("engine.round",))
    out["round"] = in_rounds - sum(out.values())
    out["none"] = sum(t - s for s, t in gaps) / 1e6 - in_rounds
    return out


def label_gap(gap_us: Tuple[float, float], spans, offset_us: float) -> str:
    """The stage whose own time (its span less its children's) covers most
    of the gap (profiler microseconds): the innermost stage the worker was
    in; "no stage" where none covers any of it."""
    g = (gap_us[0] + offset_us, gap_us[1] + offset_us)
    covered = {sp.index: _overlap(g, (sp.start_ns / 1e3, sp.end_ns / 1e3)) for sp in spans}
    own = dict(covered)
    for sp in spans:
        if sp.parent in own:
            own[sp.parent] -= covered[sp.index]
    best = max(spans, key=lambda sp: own[sp.index], default=None)
    return best.name if best is not None and own[best.index] > 0 else "no stage"
