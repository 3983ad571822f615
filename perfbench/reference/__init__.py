"""The plain references that decide ``correct``, one set of modules a model
family, each in plain float32 PyTorch (TF32 off), importing nothing of the
program and taking nothing the program made: the benchmark draws the
weights again from the seed and hands them here.

Whisper's (``mel``, ``model``, ``rules``, ``special``): the frontend,
encoder, decoder and decoding rules, written from the published model and
openai's ``whisper`` package, with the int8 quantization of the served
configuration derived again from its documented rule."""
