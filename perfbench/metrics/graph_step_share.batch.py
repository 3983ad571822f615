"""Percent of the decode steps that replayed a captured CUDA graph: engine.stats graph_steps over decode_steps over the host window (batch cells)."""

from typing import Optional


def read(rec: dict) -> Optional[float]:
    """None for a program that counts no graph steps (or ran no step)."""
    s = rec["host"]["stats"]
    if "graph_steps" not in s or not s.get("decode_steps"):
        return None
    return 100.0 * s["graph_steps"] / s["decode_steps"]
