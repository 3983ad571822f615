"""Checkpoint save and restore: params and the train state.

Port of ``whisper_tpu/training/checkpoint.py`` with ``torch.save`` and
``torch.load(weights_only=True)`` in place of orbax; the format is the
port's own (one file per checkpoint, tensors on the CPU). It gives a cache
of converted params for a fast reload of a GGML checkpoint, and whole
TrainState checkpoints for long fine-tuning jobs.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch

from .train import TrainState, map_tree


def _save(path: str, obj: Any) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a reader sees the old file or the whole new one


def _load(path: str) -> Any:
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def save_params(path: str, params: Any) -> None:
    """Save a params tree (CPU copies of its tensors) to the file ``path``."""
    _save(path, map_tree(lambda t: t.detach().cpu(), params))


def restore_params(path: str) -> Any:
    """The params tree saved at ``path``, on the CPU."""
    return _load(path)


def save_train_state(path: str, state: TrainState) -> None:
    """Persist a TrainState: params, the optimizer's moments and counts, step."""
    _save(path, {"params": map_tree(lambda t: t.detach().cpu(), state.params),
                 "opt_state": state.opt_state.state_dict(), "step": state.step})


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """Restore into ``template`` (a TrainState of the same model and
    optimizer, from ``init_train_state``): its leaves and optimizer take the
    saved values in place, on their own device."""
    saved = _load(path)

    def copy(dst: dict, src: dict) -> None:
        for key, value in src.items():
            if isinstance(value, dict):
                copy(dst[key], value)
            else:
                dst[key].copy_(value)

    with torch.no_grad():
        copy(template.params, saved["params"])
    template.opt_state.load_state_dict(saved["opt_state"])
    return TrainState(template.params, template.opt_state, int(saved["step"]))


def cached_load(ggml_path: str, cache_dir: Optional[str] = None, **kwargs):
    """``load_model`` with a cache of the converted params tree for a fast
    reload: the GGML parse and stacking dominate a cold load of a big
    model, and the cache (keyed by the file's size and mtime) skips them.
    ``kwargs`` go to ``load_model`` (``device``, ``dtype``, ``gelu_impl``)."""
    from ..config import WhisperConfig
    from ..io.vocab import make_vocab
    from ..model.decoder import TextDecoder
    from ..model.encoder import AudioEncoder
    from ..model.load import WhisperModel, load_model

    st = os.stat(ggml_path)
    key = f"{os.path.basename(ggml_path)}-{st.st_size}-{int(st.st_mtime)}"
    cache_dir = cache_dir or os.path.join(
        os.path.dirname(os.path.abspath(ggml_path)), ".whisper_tpu_torch_cache")
    params_path = os.path.join(cache_dir, key + ".pt")
    meta_path = os.path.join(cache_dir, key + ".meta.json")

    if os.path.exists(params_path) and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        config = WhisperConfig(**meta["config"])
        device = kwargs.get("device", "cuda")
        dtype = kwargs.get("dtype", torch.float32)
        params = map_tree(lambda t: t.to(device=device, dtype=dtype), restore_params(params_path))
        tokens = [bytes.fromhex(t) for t in meta["tokens"]]
        filters = torch.from_numpy(np.array(meta["filters"], dtype=np.float32)).to(device)
        return WhisperModel(config=config, params=params, filters=filters,
                            vocab=make_vocab(config.n_vocab, tokens, len(tokens)),
                            encoder=AudioEncoder(params, config),
                            decoder=TextDecoder(params, config))

    model = load_model(ggml_path, **kwargs)
    save_params(params_path, model.params)
    with open(meta_path, "w") as f:
        json.dump({
            "config": dataclasses.asdict(model.config),
            "tokens": [model.vocab.id_to_token[i].hex()
                       for i in range(len(model.vocab.id_to_token))],
            "filters": model.filters.cpu().numpy().tolist(),
        }, f)
    return model
