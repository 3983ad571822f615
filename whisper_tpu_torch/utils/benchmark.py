"""The serving step of the throughput benchmark, and its parameter preparation.

Port of ``make_serving_step`` and of the parameter preparation in
``run_benchmark`` (``whisper_tpu/utils/benchmark.py``): one 30 s window ->
log-mel -> broadcast to the batch -> encoder (W8A8 when its weights are int8)
with an int8 or bf16 cross memory -> a greedy decode of ``decode_tokens``
tokens with timestamp rules and an int8 or bf16 self cache (or, with
``beam_size=k``, the device beam over batch·k cache rows and a group-shared
cross memory), all on the model's device. The modules hold the weights, so
the step takes only the audio. The timing loop and the bench.py hook are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import N_SAMPLES_PER_CHUNK
from ..decoding.device_beam import beam_decode_device
from ..decoding.device_loop import build_masks, decode_segment_device
from ..frontend.mel import frame_count, log_mel_spectrogram, mel_window
from ..model.decoder import KVCache, init_cache
from ..model.encoder import encode
from ..model.load import WhisperModel
from ..model.params import Params
from ..model.quant import (fuse_decoder_qkv, init_quant_cache, quantize_decoder_weights,
                           quantize_encoder_weights)


def prepare_serving_params(params: Params, weight_dtype: str = "int8",
                           enc_dtype: str = "int8") -> Params:
    """The serving tree, in run_benchmark's order: int8 decoder weights,
    then the W8A8 encoder's int8 weights, then the fused decoder QKV
    (quantized first, so per-channel scales concatenate exactly). A dtype
    other than "int8" leaves that part in the model dtype. Rebuild the
    modules from the result with ``WhisperModel.with_params``."""
    if weight_dtype == "int8":
        params = quantize_decoder_weights(params)
    if enc_dtype == "int8":
        params = quantize_encoder_weights(params)
    return fuse_decoder_qkv(params)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_serving_step(model: WhisperModel, batch: int, decode_tokens: int, kv_dtype: str,
                      beam_size: Optional[int] = None
                      ) -> Callable[[np.ndarray], Tuple[torch.Tensor, torch.Tensor]]:
    """``step(audio) -> (tokens (batch, decode_tokens), lengths (batch,))``
    for one 30 s clip broadcast to ``batch`` rows. ``kv_dtype`` "int8"
    makes the cross memory and the self cache int8; "bfloat16" keeps both
    bf16. With ``beam_size=k`` the decode is the device beam, over a self
    cache of batch·k rows and the cross memory at batch ``batch``
    (group-shared), and the step returns JAX's ``(fin_tokens (batch, k,
    decode_tokens), fin_count (batch,))``. Stage wall times (mel, encode,
    decode; each ends in a device synchronise) go to ``model.timers``."""
    if kv_dtype not in ("int8", "bfloat16"):
        raise ValueError(f"kv_dtype must be 'int8' or 'bfloat16', got {kv_dtype!r}")
    cfg, vocab, device = model.config, model.vocab, model.device
    n_frames = 2 * cfg.n_audio_ctx
    sup_mask, blank_mask = build_masks(vocab, device)
    init = [vocab.token_sot]
    if cfg.is_multilingual:
        init += [vocab.language_token("en"), vocab.token_transcribe]
    k = beam_size or 1
    init_tokens = torch.tensor([init] * (batch * k), dtype=torch.long, device=device)
    seg_ctx = len(init) + decode_tokens + 8

    def step(audio: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.inference_mode():
            with model.timers.stage("mel"):
                a = torch.as_tensor(np.asarray(audio, dtype=np.float32)).to(device)
                mel = log_mel_spectrogram(a, model.filters, frame_count(N_SAMPLES_PER_CHUNK))
                mel_b = mel_window(mel, 0, n_frames)[None].expand(batch, -1, -1)
                _sync(device)
            with model.timers.stage("encode"):
                enc = encode(model.encoder, mel_b, quantize_kv=kv_dtype == "int8")
                _sync(device)
            with model.timers.stage("decode"):
                if kv_dtype == "int8":
                    cache = KVCache(*init_quant_cache(cfg, batch * k, device, ctx=seg_ctx))
                else:
                    cache = init_cache(cfg, batch * k, torch.bfloat16, device, ctx=seg_ctx)
                if beam_size:
                    out = beam_decode_device(
                        model.decoder, init_tokens, len(init), 0, cache, enc.cross_k,
                        enc.cross_v, sup_mask, blank_mask, beam_size=k,
                        sample_len=decode_tokens)
                    toks, lengths = out[2], out[5]
                else:
                    toks, lengths, _, _ = decode_segment_device(
                        model.decoder, init_tokens, len(init), 0, cache, enc.cross_k,
                        enc.cross_v, sup_mask, blank_mask, sample_len=decode_tokens,
                        use_timestamps=True)
                _sync(device)
        return toks, lengths

    return step
