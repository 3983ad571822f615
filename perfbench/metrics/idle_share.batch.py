"""Percent of the traced sub-window with no kernel running, from the union of kernel intervals (batch cells)."""

from perfbench.layers import idle_share as read  # noqa: F401
