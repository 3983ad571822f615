"""Run one cell as ``perfbench.run`` does, with the program's worker stages
recorded (``engine.spans``), to put the card's idle time down to them.

    python3 -m perfbench.spanrun --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--record-all 1]

from the repository root, on a CUDA card. With ``--trace 1`` the worker
records its stages through the profiled sub-window, whose clock the
profiler's events are put on by ``spans.clock_anchor``; standard error
then ends with ``perfbench.spans: {...}``: the idle seconds of the card in
the admission, decode and harvest stages and elsewhere
(``spans.idle_in_stages``), the shares of the sub-window they make
(``idle_admit_share`` and the others, beside ``idle_share``), and the
longest gaps, each named ``"<stage> | <runtime
call>"``. ``--record-all 1`` records from the server's start to the end of
the run, which is what the recording costs the worker (compare the host
metrics of runs with 0 and 1). The last line of standard output is
``perfbench.run``'s result line, with the host-clock per-layer metrics
beside the end-to-end ones. The benchmark's own runs are ``perfbench.run``.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

import torch  # noqa: E402

from . import run as R  # noqa: E402
from . import spans as S  # noqa: E402
from . import trace as T  # noqa: E402
from .cell import CellRun, per_layer  # noqa: E402

HOST_METRICS = ("admit_share.batch", "step_ms.batch", "init_share.batch",
                "harvest_share.batch", "decode_step_ms.batch")


def stage_readings(tr, spans, anchor_ns: int, worker_tid: Optional[int],
                   n_top: int = 10) -> Optional[dict]:
    """The card's idle time in the profiled sub-window put down to the
    worker's ``spans``: the same gaps ``trace.DeviceTrace.reduce`` reads
    (kernel intervals clipped to the wall), mapped to the spans' clock by
    the anchor. None where the profile holds no anchor or no kernel."""
    events = tr.prof.events()
    offset = S.profiler_offset_us(events, anchor_ns)
    span_us = tr.wall_s * 1e6
    kernels, ops = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == T.DeviceType.CUDA:
            kernels.append((start, end))
        elif e.device_type == T.DeviceType.CPU:
            ops.append((start, end, e.name, e.thread))
    if offset is None or not kernels:
        return None
    # the worker's runtime calls where the profile names its thread, as reduce()
    if worker_tid in {tid for *_x, tid in ops}:
        ops = [op for op in ops if op[3] == worker_tid]
    ops = [op[:3] for op in ops]
    busy = T.merge_intervals([(max(0.0, s), min(span_us, t)) for s, t in kernels
                              if t > 0 and s < span_us])
    gaps = T.idle_gaps(busy, span_us)
    idle = S.idle_in_stages(gaps, spans, offset)
    longest = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:n_top]
    shares = {f"idle_{k}_share": 100.0 * v / tr.wall_s for k, v in idle.items()}
    shares["idle_share"] = 100.0 * (1.0 - sum(t - s for s, t in busy) / span_us)
    rounds = sum(1 for sp in spans if sp.name == "engine.round")
    return {"offset_us": offset, "spans": len(spans), "rounds": rounds, "idle_s": idle,
            "shares": shares,
            "idle_gaps": [[f"{S.label_gap(g, spans, offset)} | {T.label_gap(g, ops)}",
                           (g[1] - g[0]) / 1e6] for g in longest]}


class _AnchoredTrace(T.DeviceTrace):
    """``DeviceTrace`` that, once the profiler runs, turns the engine's
    recording on and sets the clock anchor (kept in ``anchors``)."""

    def __init__(self, engine, anchors: list):
        super().__init__()
        self.engine, self.anchors = engine, anchors

    def __enter__(self):
        super().__enter__()
        self.engine.spans.record(True)
        self.anchors.append(S.clock_anchor())
        return self


class SpanCellRun(CellRun):
    """``CellRun`` with the engine's stages recorded: through the profiled
    sub-window, or from the server's start (``record_all``)."""

    def __init__(self, *args, record_all: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.record_all = record_all

    def _server(self, engine, topts):
        engine.spans.record(self.record_all)
        return super()._server(engine, topts)

    def _trace_block(self, engine, srv, t_from: float, span: float) -> None:
        """``CellRun._trace_block`` over an ``_AnchoredTrace``, then the
        stages recorded until the round open at the stretch's end has
        closed."""
        anchors: list = []
        base = T.DeviceTrace
        T.DeviceTrace = lambda: _AnchoredTrace(engine, anchors)
        try:
            super()._trace_block(engine, srv, t_from, span)
        finally:
            T.DeviceTrace = base
        tr = self.out["trace"]
        rounds = tr["s0"]["rounds"] + tr["stats"]["rounds"]
        t_end = time.perf_counter() + 60.0
        while engine.stats["rounds"] < rounds + 2 and time.perf_counter() < t_end:
            time.sleep(0.01)
        engine.spans.record(self.record_all)
        self._stages = (engine.spans.drain(), anchors[0])

    def _reduce_trace(self) -> None:
        if self._trace is not None:
            (tr, tid), (spans, anchor) = self._trace, self._stages
            self.out["stages"] = stage_readings(tr, spans, anchor, tid)
        super()._reduce_trace()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--record-all", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR", str(R.ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(R.ROOT / "build" / "torch_extensions"))
    spec = R.load_spec()
    entry, cell, config = R.load_cell(args.workload, spec)
    if not torch.cuda.is_available():
        print("perfbench.spanrun: needs a CUDA card", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = SpanCellRun(cell, config, args.seed, args.seconds, bool(args.trace), "cuda:0",
                      T_PROCESS, record_all=bool(args.record_all)).run()
    host = per_layer(dict(out, trace=None), out["dims"], cell, list(HOST_METRICS),
                     R.metric_reader)
    print("perfbench.spans: " + json.dumps({"host": host, "stages": out.get("stages")}),
          file=sys.stderr)
    return R.report(spec, args.workload, cell, out, bool(args.trace),
                    torch.cuda.get_device_name(0), per_layer)


if __name__ == "__main__":
    sys.exit(main())
