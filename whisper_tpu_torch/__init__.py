"""whisper_tpu_torch: the PyTorch/CUDA port of whisper_tpu.

The same module layout as ``whisper_tpu``; the JAX package stays the
reference the port is tested against. The port imports torch and never jax:
it reuses the JAX-free ``whisper_tpu`` modules (config, errors, io, decoding
rules and results, the numpy parameter assembly, logging).
"""
