"""K1 (attention_bf16_kernel) device time against its bound for the windows encoded, in the traced sub-window (batch cells)."""

from perfbench.layers import k1_roofline as read  # noqa: F401
