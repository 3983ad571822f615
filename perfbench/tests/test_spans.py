"""The readers of the program's stages (``perfbench/spans.py``) and the run
that records them (``perfbench/spanrun.py``): the clock anchor on a CPU
profile, the idle time put down to stages on a synthetic trace, the three
host-clock metrics in a tiny cell's rehearsal, and the program's counter of
admitted windows against the harness's own count."""

import io
import json
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import run as R
from perfbench import spans as S
from perfbench.cell import installs_in, per_layer
from perfbench.spanrun import SpanCellRun, stage_readings
from perfbench.tests.rehearsal import SEED, TINY, small_cell
from whisper_tpu_torch.utils.logging import Span, StageTimers

NEW = {"init_share.batch", "harvest_share.batch", "decode_step_ms.batch"}


def test_the_anchor_puts_profiler_events_on_the_spans_clock():
    t = StageTimers()
    t.record(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        anchor = S.clock_anchor()
        time.sleep(0.02)
        with t.stage("worker.block"):
            with record_function("block"):
                time.sleep(0.005)
    (sp,) = t.drain()
    offset = S.profiler_offset_us(prof.events(), anchor)
    ev = next(e for e in prof.events() if e.name == "block")
    assert abs(ev.time_range.start + offset - sp.start_ns / 1e3) < 500  # microseconds
    assert abs(ev.time_range.end + offset - sp.end_ns / 1e3) < 500
    assert S.profiler_offset_us([], anchor) is None


OFFSET = 5000.0  # the spans' clock runs 5 ms ahead of the profiler's
ANCHOR_NS = int(OFFSET * 1e3)  # the anchor's event sits at the profiler's 0


def _span(i, name, start_us, end_us, parent=-1):
    """A span at profiler microseconds, on the spans' clock."""
    return Span(i, name, int((start_us + OFFSET) * 1e3), int((end_us + OFFSET) * 1e3), parent,
                (), None)


# one round of the worker (profiler microseconds): admission, chunk, pull,
# harvest, each with the card idle somewhere inside it
SPANS = [_span(0, "engine.round", 0, 1000), _span(1, "server.ingest", 0, 50, 0),
         _span(2, "server.start_request", 50, 150, 0), _span(3, "engine.admit", 150, 400, 0),
         _span(4, "engine.admit.bucket", 150, 400, 3), _span(5, "engine.chunk", 400, 700, 0),
         _span(6, "engine.pull", 700, 800, 0), _span(7, "engine.finish", 800, 1000, 0)]


def _events(kernels):
    """Profiler events: the anchor and kernels at profiler microseconds."""
    ev = [SimpleNamespace(name=S.ANCHOR, time_range=SimpleNamespace(start=-1, end=1),
                          device_type=DeviceType.CPU, thread=1)]
    for s, t in kernels:
        ev.append(SimpleNamespace(name="k", time_range=SimpleNamespace(start=s, end=t),
                                  device_type=DeviceType.CUDA, thread=0))
    return ev


def test_idle_time_is_put_down_to_the_stages_and_sums_to_the_idle_share():
    # busy 0-40, 200-390, 420-690, 850-900 of a 1000 us window
    kernels = [(0, 40), (200, 300), (290, 390), (420, 690), (850, 900)]
    tr = SimpleNamespace(prof=SimpleNamespace(events=lambda: _events(kernels)), wall_s=1e-3)
    r = stage_readings(tr, SPANS, ANCHOR_NS, worker_tid=1)
    assert r["offset_us"] == pytest.approx(OFFSET)
    idle = {k: v * 1e6 for k, v in r["idle_s"].items()}
    # gaps 40-200 (ingest 40-50, start 50-150, admit 150-200), 390-420
    # (admit 390-400, chunk 400-420), 690-850 (chunk, pull, finish), 900-1000
    assert idle["admit"] == pytest.approx(100 + 50 + 10)
    assert idle["decode"] == pytest.approx(20 + 10 + 100)
    assert idle["harvest"] == pytest.approx(50 + 100)
    assert idle["ingest"] == pytest.approx(10)
    assert idle["round"] == pytest.approx(0, abs=1e-9) and idle["none"] == pytest.approx(0)
    sh = r["shares"]
    assert sh["idle_share"] == pytest.approx(100 * 450 / 1000)
    parts = sh["idle_admit_share"] + sh["idle_decode_share"] + sh["idle_harvest_share"]
    assert parts <= sh["idle_share"] + 1e-9
    rest = sh["idle_ingest_share"] + sh["idle_round_share"] + sh["idle_none_share"]
    assert parts + rest == pytest.approx(sh["idle_share"])
    # the longest gap lies in the admission; its label names the stage
    label, seconds = r["idle_gaps"][0]
    assert seconds == pytest.approx(160e-6) and label == "server.start_request | no cpu op"


def test_the_rest_of_the_idle_time_is_split_by_where_the_worker_was():
    spans = [sp for sp in SPANS if sp.name != "server.start_request"]
    idle = S.idle_in_stages([(40, 200), (1000, 1100)], spans, OFFSET)
    # 40-50 ingest, 50-150 the round's own time, 150-200 admission, and
    # 1000-1100 in no recorded round
    assert idle == pytest.approx({"admit": 50e-6, "decode": 0.0, "harvest": 0.0,
                                  "ingest": 10e-6, "round": 100e-6, "none": 100e-6})


def test_a_gap_is_named_by_the_innermost_stage_over_it():
    assert S.label_gap((160, 390), SPANS, OFFSET) == "engine.admit.bucket"
    assert S.label_gap((700, 790), SPANS, OFFSET) == "engine.pull"
    assert S.label_gap((2000, 3000), SPANS, OFFSET) == "no stage"


def test_no_anchor_or_no_kernel_reads_nothing():
    tr = SimpleNamespace(prof=SimpleNamespace(events=lambda: _events([])), wall_s=1e-3)
    assert stage_readings(tr, SPANS, ANCHOR_NS, worker_tid=1) is None
    tr = SimpleNamespace(prof=SimpleNamespace(events=lambda: _events([(0, 1)])[1:]),
                         wall_s=1e-3)
    assert stage_readings(tr, SPANS, ANCHOR_NS, worker_tid=1) is None


def test_the_host_readers_return_nothing_for_a_program_without_the_totals():
    rec = {"host": {"window_s": 2.0, "stats": {"admit_s": 0.5, "chunk_s": 1.0,
                                               "pull_s": 0.2, "rounds": 3}}}
    assert S.init_share(rec) is S.harvest_share(rec) is S.decode_step_ms(rec) is None
    rec["host"]["stats"].update(init_s=0.1, harvest_s=0.3, decode_steps=40)
    assert S.init_share(rec) == pytest.approx(5.0)
    assert S.harvest_share(rec) == pytest.approx(15.0)
    assert S.decode_step_ms(rec) == pytest.approx(30.0)


def test_a_recorded_cell_reads_the_new_metrics_and_counts_the_harness_s_windows():
    """One tiny cell through SpanCellRun on the CPU, traced: the result line
    holds the three host metrics and no idle share (no device trace here);
    the stages were recorded and anchored; the program's encode_windows
    over the window equal the harness's count at _install_bucket."""
    torch.set_num_threads(2)
    name = "large-v3-turbo.batch-int8"
    spec, cell, config = small_cell(name)
    run = SpanCellRun(cell, config, SEED, 8.0, True, "cpu", time.perf_counter(), dims=TINY)
    out = run.run()
    assert out["correct"], out["readings"]
    buf = io.StringIO()
    assert R.report(spec, name, cell, out, True, "cpu", per_layer, stream=buf) == 0
    metrics = json.loads(buf.getvalue().splitlines()[-1])["metrics"]
    assert NEW <= set(metrics) and all(metrics[k]["value"] > 0 for k in NEW)
    assert not any("idle" in k or "roofline" in k for k in metrics)
    assert out["stages"] is None  # no kernel in a CPU profile
    (t_open, _s), (t_close, _t) = out["snaps"]
    assert out["stats"]["encode_windows"] == installs_in(run.installs, [(t_open, t_close)])[0]
    assert out["stats"]["encode_windows"] > 0
    assert out["stats"]["decode_steps"] <= out["stats"]["rounds"] * cell["engine"]["chunk_steps"]
