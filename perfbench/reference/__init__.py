"""The plain reference that decides ``correct``: Whisper's frontend, encoder,
decoder and decoding rules in plain float32 PyTorch (TF32 off), written from
the published model and openai's ``whisper`` package, with the int8
quantization of the served configuration derived again from its documented
rule. It imports nothing of the program and takes nothing the program made:
the benchmark draws the weights again from the seed and hands them here."""
