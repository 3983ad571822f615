"""Percent of the window the worker spent starting requests (clip mel, language detection): engine.stats init_s over the window (batch cells)."""

from perfbench.spans import init_share as read  # noqa: F401
