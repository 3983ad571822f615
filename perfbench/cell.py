"""One run of one cell: the program built from the seed, the cell's traffic
through ``EngineServer.submit``, a warm-up, the measured window, the trace
of a sub-window, and the comparison with the reference.

The model is reached through the configuration's family
(``perfbench/families``): its sizes, its weights from the seed, the served
program and the comparison with its reference. From the program
(``whisper_tpu_torch``) this takes ``EngineServer`` with ``submit`` and
``engine.stats``, its kernels' build and ``kernel_launches``; it counts the
windows each admission bucket holds at ``SlotEngine._install_bucket``,
which no counter of the program reports yet. Every timing is the
benchmark's own host clock (``time.perf_counter``), taken in the futures'
done callbacks, which run on the server's worker thread as it resolves each
request.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import List, Optional

import torch

from . import check, families, traffic as traffic_mod

RAMP = (1, 2, 4, 8, 16)  # warm-up joins: each admission bucket size once


def launches() -> dict:
    from whisper_tpu_torch.utils.benchmark import kernel_launches

    return dict(kernel_launches())


class Recorder:
    """Each request's times, outcome and result; the engine's stats and the
    launch counters at each resolution."""

    def __init__(self, engine, on_done=None):
        self.engine = engine
        self.on_done = on_done
        self.lock = threading.Lock()
        self.entries: List[dict] = []

    def submit(self, srv, tr, req, t_due: float, phase: str) -> dict:
        entry = {"idx": req.idx, "samples": req.samples, "offset": req.offset,
                 "language": req.language, "t_due": t_due, "t_done": None,
                 "result": None, "error": None, "phase": phase}
        with self.lock:
            self.entries.append(entry)
        fut = srv.submit(tr.audio(req), language=req.language)
        fut.add_done_callback(lambda f: self._finish(entry, f))
        return entry

    def _finish(self, entry: dict, fut) -> None:
        entry["t_done"] = time.perf_counter()
        if fut.cancelled():
            entry["error"] = "cancelled"
        elif fut.exception() is not None:
            entry["error"] = repr(fut.exception())
        else:
            entry["result"] = fut.result()
        entry["stats"] = dict(getattr(self.engine, "stats", {}) or {})
        entry["launches"] = launches()
        if self.on_done is not None:
            self.on_done(entry)

    def resolved(self) -> List[dict]:
        with self.lock:
            return [e for e in self.entries if e["t_done"] is not None]


class ClosedLoop:
    """Keeps ``target`` requests in flight: each resolution submits the next."""

    def __init__(self, srv, tr, rec: Recorder):
        self.srv, self.tr, self.rec = srv, tr, rec
        self.lock = threading.Lock()
        self.target = self.inflight = self.next = 0
        self.stopped = False
        self.phase = "warmup"
        rec.on_done = self._done

    def top_up(self) -> None:
        with self.lock:
            n = 0 if self.stopped else max(0, self.target - self.inflight)
            self.inflight += n
            first, self.next = self.next, self.next + n
        for i in range(first, first + n):
            self.rec.submit(self.srv, self.tr, self.tr.request(i), time.perf_counter(),
                            self.phase)

    def _done(self, _entry) -> None:
        with self.lock:
            self.inflight -= 1
        self.top_up()


def wait_until(pred, timeout: float, what: str, poll: float = 0.01) -> None:
    t_end = time.perf_counter() + timeout
    while not pred():
        if time.perf_counter() > t_end:
            raise TimeoutError(f"no {what} within {timeout:.0f} s")
        time.sleep(poll)


def _build_kernels() -> None:
    """Every CUDA kernel of the program built (nvcc, first run in a
    checkout) and loaded, at once."""
    from whisper_tpu_torch.kernels import build

    build.build_all(sorted(p.stem for p in build.CSRC.glob("*.cu")))


def count_installs(engine) -> List[tuple]:
    """(host time, windows, bucket rows) of each admission bucket the engine
    installs from now on: the windows are the real ones, the rows include
    the bucket's padding; none for an engine without admission buckets."""
    installs: List[tuple] = []
    real = getattr(engine, "_install_bucket", None)
    if real is None:
        return installs

    def install(slot_list, wins, bucket, *args, **kwargs):
        installs.append((time.perf_counter(), len(slot_list), int(bucket)))
        return real(slot_list, wins, bucket, *args, **kwargs)

    engine._install_bucket = install
    return installs


def installs_in(installs: List[tuple], parts) -> tuple:
    """(windows, bucket rows, buckets) installed within the (start, end) parts."""
    inside = [i for i in list(installs) if any(a <= i[0] < b for a, b in parts)]
    return sum(i[1] for i in inside), sum(i[2] for i in inside), len(inside)


def _worker_tid(srv) -> Optional[int]:
    t = getattr(srv, "_thread", None)
    return getattr(t, "native_id", None)


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a.get(k, 0) for k in b if isinstance(b[k], (int, float))}


def bursts(times: List[float], quiet: float = 0.05) -> List[list]:
    """[end, size] of each burst of resolutions (resolutions closer than
    ``quiet`` seconds belong to one burst)."""
    out: List[list] = []
    for t in sorted(times):
        if out and t - out[-1][0] <= quiet:
            out[-1][0] = t
            out[-1][1] += 1
        else:
            out.append([t, 1])
    return out


def cycle_window(times: List[float], t_from: float, seconds: float, slots: int) -> tuple:
    """(open, close) on the ends of the largest bursts between ``t_from`` and
    ``t_from + seconds``. With every window decoding to the token cap the
    slots finish in a few groups that keep their phase, one of them holding
    at least 0.4 of the slots; between two of its bursts lie whole cycles
    of the engine's work. Where no such group recurs, any two bursts."""
    inside = [b for b in bursts(times) if t_from <= b[0] <= t_from + seconds]
    big = [b for b in inside if b[1] >= 0.4 * slots]
    ends = big if len(big) >= 2 else inside
    if len(ends) < 2:
        raise RuntimeError("fewer than two bursts of resolutions in the window: "
                           "lengthen --seconds")
    return ends[0][0], ends[-1][0]


class CellRun:
    def __init__(self, cell: dict, config: dict, seed: int, seconds: float, trace: bool,
                 device, t_process: float, dims: Optional[dict] = None, control: bool = False):
        self.cell, self.config, self.seed = cell, config, int(seed)
        self.seconds, self.trace, self.device = float(seconds), bool(trace), torch.device(device)
        self.t_process = t_process
        self.control = control  # the control in the program's place (run.py --control 1)
        self._trace = None
        self.family = families.of(config)
        self.dims = dims or self.family.dims(config)
        self.tr = traffic_mod.Traffic(cell["traffic"], self.seed)
        self.out: dict = {}

    # -- phases --

    def run(self) -> dict:
        on_card = self.device.type == "cuda"
        if on_card:
            _build_kernels()
        tree = self.family.draw(self.dims, self.seed, torch.bfloat16, self.device)
        engine, topts = self.family.build(self.dims, tree, self.cell, self.device)
        del tree
        self.installs = count_installs(engine)
        self._closed(engine, topts)
        self._reduce_trace()
        self._host()
        self.out["dims"] = self.dims
        self.out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(self.device)
                                         if on_card else 0)
        del engine
        gc.collect()
        if on_card:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        self._check()
        return self.out

    def _server(self, engine, topts):
        from whisper_tpu_torch.parallel.server import EngineServer

        return EngineServer(engine, topts).start()

    def _ramp(self, engine, offer, submitted) -> None:
        """Joins of 1, 2, 4, 8 and 16 requests, each admitted before the
        next is offered, so that every admission bucket runs once."""
        for k in RAMP:
            offer(k)
            n = submitted()
            wait_until(lambda: getattr(engine, "stats", {}).get("requests", -1) >= n,
                       300, f"admission of {n} warm-up requests")

    def _trace_block(self, engine, srv, t_from: float, span: float) -> None:
        """Profile ``span`` seconds from ``t_from``. The profiler's stop and
        the reading of its events hold the interpreter's lock and slow the
        worker, so the host-clock metrics leave out everything from the
        start to the end of the stop, and the events are read after the
        window."""
        from .trace import DeviceTrace

        time.sleep(max(0.0, t_from - time.perf_counter()))
        s0, l0 = dict(engine.stats), launches()
        with DeviceTrace() as tr:
            time.sleep(span)
            s1, l1 = dict(engine.stats), launches()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._trace = (tr, _worker_tid(srv))
        windows, rows, buckets = installs_in(self.installs, [(tr.t0, tr.t0 + tr.wall_s)])
        self.out["trace"] = {"stats": _delta(s0, s1), "launches": _delta(l0, l1),
                             "t0": t_from, "t1": time.perf_counter(), "s0": s0,
                             "s1": dict(engine.stats), "encode_windows": windows,
                             "encode_rows": rows, "encode_buckets": buckets}

    def _reduce_trace(self) -> None:
        if self._trace is not None:
            tr, tid = self._trace
            self.out["trace"].update(tr.reduce(worker_tid=tid))
            self._trace = None

    def _sub_window(self, t_open: float):
        span = min(10.0, self.seconds / 2)
        return t_open + (self.seconds - span) / 2, span

    def _closed(self, engine, topts) -> None:
        srv = self._server(engine, topts)
        rec = Recorder(engine)
        cl = ClosedLoop(srv, self.tr, rec)
        try:
            wait_until(lambda: "requests" in (getattr(engine, "stats", None) or {}), 60,
                       "server start")

            def offer(k):
                cl.target += k
                cl.top_up()

            self._ramp(engine, offer, lambda: cl.next)
            cl.target = self.cell["traffic"]["outstanding"]
            cl.top_up()
            slots = self.cell["engine"]["slots"]
            base = len(rec.resolved())
            wait_until(lambda: len(rec.resolved()) >= base + slots, 600, "a first wave")
            cl.phase = "window"
            t_nominal = time.perf_counter()
            wait_until(lambda: any(e["t_done"] > t_nominal for e in rec.resolved()), 120,
                       "a resolution")
            t_first = min(e["t_done"] for e in rec.resolved() if e["t_done"] > t_nominal)
            self.out["setup_s"] = t_first - self.t_process
            if self.trace:
                self._trace_block(engine, srv, *self._sub_window(t_first))
            time.sleep(max(0.0, t_first + self.seconds + 0.5 - time.perf_counter()))
            with cl.lock:
                cl.stopped = True
        finally:
            srv.stop(drain=False)
        done = rec.resolved()
        t_open, t_close = cycle_window([e["t_done"] for e in done], t_first, self.seconds,
                                       self.cell["engine"]["slots"])
        inside = [e for e in done if t_open < e["t_done"] <= t_close]
        at_open = max((e for e in done if e["t_done"] <= t_open), key=lambda e: e["t_done"])
        at_close = max(inside, key=lambda e: e["t_done"])
        ok = [e for e in inside if e["result"] is not None]
        failed = [e for e in inside if e["error"] is not None and e["error"] != "cancelled"]
        window_s = t_close - t_open
        self.out["snaps"] = ((t_open, at_open["stats"]), (t_close, at_close["stats"]))
        self.out.update(
            kind="batch", window_s=window_s, attempted=len(ok) + len(failed),
            failed=len(failed), unanswered=len(failed),
            stats=_delta(at_open["stats"], at_close["stats"]),
            launches=_delta(at_open["launches"], at_close["launches"]),
            done=ok,
            e2e={"audio_s_per_s": sum(e["samples"] for e in ok) / 16000.0 / window_s})

    def _host(self) -> None:
        """The window without its profiled stretch, from the profiler's start
        to the end of its stop (its own cost falls there): what the
        host-clock per-layer metrics read."""
        (t_open, s_open), (t_close, s_close) = self.out["snaps"]
        tr = self.out.get("trace")
        if tr is None:
            parts = [((t_open, s_open), (t_close, s_close))]
        else:
            parts = [((t_open, s_open), (tr["t0"], tr["s0"]))]
            if tr["t1"] < t_close:
                parts.append(((tr["t1"], tr["s1"]), (t_close, s_close)))
        stats: dict = {}
        for (_a, sa), (_b, sb) in parts:
            for k, v in _delta(sa, sb).items():
                stats[k] = stats.get(k, 0) + v
        spans = [(a, b) for (a, _x), (b, _y) in parts]
        self.out["host"] = {
            "window_s": sum(b - a for a, b in spans), "stats": stats,
            "encode_windows": installs_in(self.installs, spans)[0],
            "done": [e for e in self.out["done"] if any(a < e["t_done"] <= b for a, b in spans)]}

    def _check(self) -> None:
        c = self.cell["check"]
        picked = check.sample(self.out["done"], self.seed, c["min_tokens"], c["max_requests"])
        tree = self.family.draw(self.dims, self.seed, torch.bfloat16, self.device)
        t0 = time.perf_counter()
        bank = self.tr.bank
        r = self.family.readings(picked, tree, self.dims,
                                 lambda e: bank[e["offset"]: e["offset"] + e["samples"]],
                                 self.device, control=self.control)
        r["check_s"] = time.perf_counter() - t0
        r["unanswered"] = self.out["unanswered"]
        self.out["readings"] = r
        self.out["correct"] = all(r[k] <= lim for k, lim in c["limits"].items()) and bool(picked)


def profiler_cost(out: dict, chunk_steps: int) -> Optional[dict]:
    """The worker's unit costs inside the profiled stretch and outside it:
    host ms a decode step and admission ms a window encoded."""
    tr, host = out.get("trace"), out.get("host")
    if not tr or not host:
        return None

    def ms(stats, keys, n):
        """Host ms of ``keys``' seconds over ``n``; None where a key is unread."""
        if not n or any(k not in stats for k in keys):
            return None
        return 1000.0 * sum(stats[k] for k in keys) / n

    def costs(stats, windows):
        return (ms(stats, ("chunk_s", "pull_s"), stats.get("rounds", 0) * chunk_steps),
                ms(stats, ("admit_s",), windows))

    traced = costs(tr["stats"], tr["encode_windows"])
    untraced = costs(host["stats"], host["encode_windows"])
    return {"step_ms": (traced[0], untraced[0]), "admit_ms_a_window": (traced[1], untraced[1])}


def per_layer(out: dict, dims: dict, cell: dict, names: List[str], reader) -> dict:
    """The per-layer metrics ``names`` that ``reader(name)`` finds a value for."""
    rec = dict(out, dims=dims, cell=cell)
    values = {}
    for name in names:
        v = reader(name)(rec)
        if v is not None:
            values[name] = v
    return values

