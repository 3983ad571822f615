"""Model loading: GGML file -> WhisperModel on one torch device.

Port of ``whisper_tpu/model/load.py``: the checkpoint is read by the native
C++ runtime (``runtime/native.py``, mmap'd) or, with ``use_native=False`` or
when the runtime is unavailable, by the pure-Python reader
(``io.ggml.load_ggml``); the log line names the reader that ran.
``random_model`` builds a model with random weights and no checkpoint.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import WhisperConfig
from ..frontend.mel import mel_filter_bank
from ..io.ggml import GGMLCheckpoint, load_ggml
from ..io.vocab import WhisperVocab, make_vocab
from ..utils.logging import StageTimers, get_logger
from .decoder import TextDecoder
from .encoder import AudioEncoder
from .params import Params, params_from_ggml, params_to_torch, random_params, random_params_device

log = get_logger("model")


@dataclasses.dataclass
class WhisperModel:
    config: WhisperConfig
    params: Params          # tensor tree, the JAX package's layout
    filters: torch.Tensor   # (n_mel, 201) f32
    vocab: WhisperVocab
    encoder: AudioEncoder
    decoder: TextDecoder
    timers: StageTimers = dataclasses.field(default_factory=StageTimers)

    @property
    def dtype(self) -> torch.dtype:
        """The activation dtype (the positional embedding's: weights may be int8)."""
        return self.params["decoder"]["pe"].dtype

    @property
    def device(self) -> torch.device:
        return self.filters.device

    def with_params(self, params: Params) -> "WhisperModel":
        """The same model on a new parameter tree (for example one from
        ``utils.benchmark.prepare_serving_params``), with its encoder and
        decoder modules rebuilt from it."""
        return dataclasses.replace(self, params=params,
                                   encoder=AudioEncoder(params, self.config),
                                   decoder=TextDecoder(params, self.config))


def _checkpoint_via_native(path: str) -> Optional[GGMLCheckpoint]:
    from ..runtime.native import native_open_ggml

    out = native_open_ggml(path)
    if out is None:
        return None
    header, filters, tokens, tensors = out
    config = WhisperConfig(*header).validate()
    vocab = make_vocab(config.n_vocab, tokens, len(tokens))
    return GGMLCheckpoint(config=config, filters=filters, vocab=vocab, tensors=tensors)


def load_model(path: str, *, device: torch.device | str = "cuda",
               dtype: torch.dtype = torch.float32,
               gelu_impl: str = "erf", use_native: bool = True) -> WhisperModel:
    """Load a GGML checkpoint onto ``device`` (the card unless the caller
    asks for the CPU) with weights in ``dtype`` (f32 for parity, bf16 for
    serving); moments and softmax always run f32. ``use_native`` reads the
    file with the native runtime when it is available."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    from ..runtime import native

    t0 = time.perf_counter()
    ckpt = _checkpoint_via_native(path) if use_native else None
    reader = "native"
    if ckpt is None:
        ckpt = load_ggml(path)
        reader = "python"
        native.count("ggml-python")
    config = dataclasses.replace(ckpt.config, gelu_impl=gelu_impl)
    params = params_to_torch(params_from_ggml(ckpt.tensors, config, dtype=np.float32),
                             device, dtype)
    filters = torch.from_numpy(ckpt.filters).to(device=device, dtype=torch.float32)
    model = WhisperModel(config=config, params=params, filters=filters, vocab=ckpt.vocab,
                         encoder=AudioEncoder(params, config),
                         decoder=TextDecoder(params, config))
    model.timers.totals["load"] = time.perf_counter() - t0
    model.timers.counts["load"] = 1
    log.info("loaded %s (%s, %s on %s, %s reader) in %.2fs", path, config.model_type, dtype,
             filters.device, reader, model.timers.totals["load"])
    return model


def random_model(config: WhisperConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda", on_device: bool = True) -> WhisperModel:
    """A model with random weights (scale 0.02) and a ``tok<i>`` vocabulary,
    for benchmarks, training runs and tests; no checkpoint. With
    ``on_device`` the weights are drawn on ``device`` by a seeded
    ``torch.Generator`` (``random_params_device``: large-v3 needs no host
    staging); otherwise they are JAX's numpy draws (``random_params``),
    rounded to ``dtype`` on the device."""
    if on_device:
        params = random_params_device(config, seed, dtype, device)
    else:
        params = params_to_torch(random_params(config, seed=seed), device, dtype)
    filters = torch.from_numpy(mel_filter_bank(config.n_mels)).to(device=device,
                                                                   dtype=torch.float32)
    tokens = [f"tok{i}".encode() for i in range(config.n_vocab)]
    return WhisperModel(config=config, params=params, filters=filters,
                        vocab=make_vocab(config.n_vocab, tokens, config.n_vocab),
                        encoder=AudioEncoder(params, config), decoder=TextDecoder(params, config))
