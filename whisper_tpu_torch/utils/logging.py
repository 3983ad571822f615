"""Logging and per-stage wall-clock timers.

The port's own copy of ``whisper_tpu/utils/logging.py``; its loggers live
under ``whisper_tpu_torch``.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from typing import Dict

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


class StageTimers:
    """Cumulative per-stage wall-clock timers."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            lines.append(
                f"  t_{name:<8s} = {self.totals[name] * 1e3:9.2f} ms"
                f"  ({self.counts[name]} calls)"
            )
        return "\n".join(lines)
