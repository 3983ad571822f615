"""Host ms a decode step: engine.stats (chunk_s + pull_s) over rounds x chunk steps (batch cells)."""

from perfbench.layers import step_ms as read  # noqa: F401
