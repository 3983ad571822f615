"""Percent of the window the engine spent admitting: engine.stats admit_s over the window (batch cells)."""

from perfbench.layers import admit_share as read  # noqa: F401
