"""Host ms a decode step: engine.stats (chunk_s + pull_s) over decode_steps, the steps the chunks ran (batch cells)."""

from perfbench.spans import decode_step_ms as read  # noqa: F401
