"""The device trace of a sub-window: torch.profiler over CPU and CUDA, kept in
memory (no file is written), reduced to kernel time by name, the union of
kernel intervals (busy time), and the longest idle gaps, each labelled by
the call that overlaps it most on the program's worker thread.

The profiler is started from the harness's thread, so it records no CPU
operation of the worker thread (recording every thread's operations slowed
the worker's decode step several times over); CUPTI still records every
kernel and every CUDA runtime call (launches, copies, pinned allocations,
synchronisations) with the thread that made it, and those label the gaps.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


class DeviceTrace:
    """``with DeviceTrace() as tr:`` profiles the block; then ``reduce``."""

    def __init__(self):
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.t0 = self.wall_s = 0.0

    def __enter__(self):
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)

    def reduce(self, worker_tid: Optional[int] = None, n_top: int = 10) -> dict:
        """{"window_s", "busy_s", "kernel_s": {name: s}, "kernel_n": {name:
        launches}, "device_ops", "idle_gaps"}: times in seconds over the
        profiled wall (``t0`` on, ``wall_s`` long, host clock)."""
        events = self.prof.events()
        span_us = self.wall_s * 1e6
        kernels: List[Tuple[float, float, str]] = []
        cpu_ops: List[Tuple[float, float, str, int]] = []
        for e in events:
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                kernels.append((start, end, e.name))
            elif e.device_type == DeviceType.CPU:
                cpu_ops.append((start, end, e.name, e.thread))
        kernel_s: dict = {}
        kernel_n: dict = {}
        for s, t, name in kernels:
            kernel_s[name] = kernel_s.get(name, 0.0) + max(0.0, t - s) / 1e6
            kernel_n[name] = kernel_n.get(name, 0) + 1
        busy = merge_intervals([(max(0.0, s), min(span_us, t)) for s, t, _ in kernels
                                if t > 0 and s < span_us])
        busy_us = sum(t - s for s, t in busy)
        gaps = idle_gaps(busy, span_us)
        gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
        threads = {tid for *_x, tid in cpu_ops}
        if worker_tid is not None and worker_tid in threads:
            ops = [(s, t, n) for s, t, n, tid in cpu_ops if tid == worker_tid]
        else:
            ops = [(s, t, n) for s, t, n, _tid in cpu_ops]
        labelled = [[label_gap(g, ops), (g[1] - g[0]) / 1e6] for g in gaps[:n_top]]
        top = sorted(kernel_s.items(), key=lambda kv: kv[1], reverse=True)[:n_top]
        return {"window_s": self.wall_s, "busy_s": busy_us / 1e6, "kernel_s": kernel_s,
                "kernel_n": kernel_n,
                "n_kernels": len(kernels), "device_ops": [[n, s] for n, s in top],
                "idle_gaps": labelled}


def merge_intervals(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out: list = []
    for s, t in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def idle_gaps(busy: list, span: float) -> list:
    """The stretches of [0, span] that no busy interval covers."""
    gaps, at = [], 0.0
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if span > at:
        gaps.append((at, span))
    return gaps


def label_gap(gap, ops) -> str:
    """The name of the CPU operation that overlaps ``gap`` the longest, or
    "no cpu op" where none does."""
    best, best_len = "no cpu op", 0.0
    for s, t, name in ops:
        ov = min(t, gap[1]) - max(s, gap[0])
        if ov > best_len:
            best, best_len = name, ov
    return best
