"""K4 (attention_int8_kernel) device time against its bound over all its launches, in the traced sub-window (batch cells)."""

from perfbench.layers import k4_roofline as read  # noqa: F401
