"""Percent of the bf16 peak: model operations of the requests resolved in the window over the window (batch cells)."""

from perfbench.layers import mfu as read  # noqa: F401
