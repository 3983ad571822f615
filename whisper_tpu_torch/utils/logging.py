"""Logging, per-stage wall-clock timers and their spans.

The port's own copy of ``whisper_tpu/utils/logging.py``; its loggers live
under ``whisper_tpu_torch``. ``StageTimers`` adds to the original a record
of each stage (``Span``), which the serving engine's worker keeps while
recording is on.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from contextlib import contextmanager
from typing import Deque, Dict, List, NamedTuple, Optional, Sequence, Tuple

_FORMAT = "%(asctime)s %(name)s: %(message)s"
_ROOT = "whisper_tpu_torch"


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"{_ROOT}.{name}")
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
    return logger


class Span(NamedTuple):
    """One stage as a recorder kept it: its index (stages are numbered as
    they begin), its name, its start and end on ``time.perf_counter_ns``,
    the index of the stage open around it on the same recorder when it
    began (-1: none), the request ids it served and its size (an admission
    bucket's rows), or None."""

    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    ids: Tuple[int, ...]
    size: Optional[int]


_OWN_NAME = object()  # stage(): the seconds go to the total named as the stage


class StageTimers:
    """Cumulative per-stage wall-clock timers and, while recording is on, a
    bounded record of the stages.

    ``stage(name)`` adds the block's seconds to ``totals`` (under its name,
    under another key given as ``total``, or nowhere with ``total=None``)
    and counts it in ``counts``; ``count(key, n)`` adds to a counter in
    ``totals``. After ``record(True)`` each stage that ends is kept as a
    ``Span`` in a buffer of the last ``maxlen``, which ``drain()`` empties;
    recording is off until then. A stage reads the host clock
    (``time.perf_counter_ns``) and nothing else: no device call, no wait.
    Stages of one recorder nest on one thread; ``record`` and ``drain`` may
    be called from any.
    """

    def __init__(self, maxlen: int = 1 << 16):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.recording = False
        self._spans: Deque[Span] = deque(maxlen=maxlen)
        self._open: List[int] = []  # indices of the stages open now, innermost last
        self._next = 0

    @contextmanager
    def stage(self, name: str, total=_OWN_NAME, ids: Sequence[int] = (),
              size: Optional[int] = None):
        index, parent = self._next, (self._open[-1] if self._open else -1)
        self._next += 1
        self._open.append(index)
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            self._open.pop()
            key = name if total is _OWN_NAME else total
            if key is not None:
                self.totals[key] = self.totals.get(key, 0.0) + (t1 - t0) / 1e9
            self.counts[name] = self.counts.get(name, 0) + 1
            if self.recording:
                self._spans.append(Span(index, name, t0, t1, parent, tuple(ids), size))

    def count(self, key: str, n: int = 1) -> None:
        self.totals[key] = self.totals.get(key, 0) + n

    def count_together(self, **counts: int) -> None:
        """Add to several counters in one update of ``totals``: a copy of it
        taken on another thread holds all of the additions or none."""
        t = self.totals
        t.update({k: t.get(k, 0) + n for k, n in counts.items()})

    def record(self, on: bool) -> None:
        """Keep the stages that end from now on (True), or stop (False)."""
        self.recording = bool(on)

    def drain(self) -> List[Span]:
        """The spans kept so far, oldest first (in the order they ended),
        taken out of the buffer."""
        out = []
        while self._spans:
            out.append(self._spans.popleft())
        return out

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            lines.append(
                f"  t_{name:<8s} = {self.totals[name] * 1e3:9.2f} ms"
                f"  ({self.counts[name]} calls)"
            )
        return "\n".join(lines)
