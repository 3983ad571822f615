"""Percent of the window the worker spent on finished windows after each pull (results, segments, futures): engine.stats harvest_s over the window (batch cells)."""

from perfbench.spans import harvest_share as read  # noqa: F401
