"""whisper_tpu_torch: the PyTorch/CUDA port of whisper_tpu.

The same module layout as ``whisper_tpu``; the JAX package stays the
reference the port is tested against. The port imports torch, never jax and
nothing of the JAX package: it keeps its own copies of the host-side modules
it needs (config, errors, io, decoding rules and results, the numpy
parameter assembly, logging).
"""
