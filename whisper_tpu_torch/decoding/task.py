"""Decoding options, initial tokens and the greedy device decode.

Port of the device-greedy part of ``whisper_tpu/decoding/task.py``:
``DecodingOptions``, the 32-token prefill bucket, openai's initial-token
construction, and ``decode_full`` through ``decode_segment_device``. Beam
search, ``best_of`` groups and the host-orchestrated loop are not ported yet
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from whisper_tpu.config import WhisperConfig
from whisper_tpu.decoding.result import DecodingResult, compression_ratio
from whisper_tpu.io.vocab import WhisperVocab

from ..model.decoder import TextDecoder, init_cache


@dataclasses.dataclass(frozen=True)
class DecodingOptions:
    task: str = "transcribe"           # "transcribe" | "translate"
    language: Optional[str] = None     # None -> "en" on multilingual models
    temperature: float = 0.0
    sample_len: Optional[int] = None   # default n_text_ctx // 2
    best_of: Optional[int] = None      # sampling candidates when temperature > 0
    beam_size: Optional[int] = None    # beam search when temperature == 0
    patience: Optional[float] = None
    length_penalty: Optional[float] = None
    prompt: Optional[Sequence[int]] = None   # previous-text conditioning tokens
    prefix: Optional[Sequence[int]] = None   # forced start of this segment
    suppress_tokens: Optional[Sequence[int]] = (-1,)
    suppress_blank: bool = True
    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0
    seed: int = 42


_PREFILL_BUCKET = 32


def _cross_batch(cross) -> int:
    """Batch size of the (L, B, ...) cross memory, float or QuantKV."""
    return getattr(cross, "data", cross).shape[1]


def _cache_dtype(cross) -> torch.dtype:
    """Self-cache dtype: bf16 when the cross memory is int8."""
    arr = getattr(cross, "data", cross)
    return torch.bfloat16 if arr.dtype == torch.int8 else arr.dtype


def _pad_to_bucket(tokens: np.ndarray) -> Tuple[np.ndarray, int]:
    t = tokens.shape[1]
    padded = (t + _PREFILL_BUCKET - 1) // _PREFILL_BUCKET * _PREFILL_BUCKET
    if padded == t:
        return tokens, t
    out = np.zeros((tokens.shape[0], padded), dtype=tokens.dtype)
    out[:, :t] = tokens
    return out, t


class DecodingTask:
    """The option checks and token layout of openai's ``DecodingTask``
    (the host decode loop itself is not ported)."""

    def __init__(self, config: WhisperConfig, vocab: WhisperVocab, options: DecodingOptions):
        self.config = config
        self.vocab = vocab
        self.options = options
        # option-compatibility contract (openai decoding.py _verify_options)
        if options.beam_size is not None and options.best_of is not None:
            raise ValueError("beam_size and best_of can't be given together")
        if options.beam_size is not None and options.temperature > 0:
            raise ValueError("beam search is only valid at temperature 0")
        if options.temperature == 0 and options.best_of is not None:
            raise ValueError("best_of with greedy sampling is not compatible")
        if options.patience is not None and options.beam_size is None:
            raise ValueError("patience requires beam_size to be given")
        self.sample_len = options.sample_len or config.n_text_ctx // 2
        self.sot_sequence = self._sot_sequence()
        self.initial_tokens = self._initial_tokens()
        self.sample_begin = len(self.initial_tokens)
        self.sot_index = self.initial_tokens.index(vocab.token_sot)

    def _sot_sequence(self) -> List[int]:
        v = self.vocab
        seq = [v.token_sot]
        if v.is_multilingual:
            seq.append(v.language_token(self.options.language or "en"))
            seq.append(v.token_translate if self.options.task == "translate"
                       else v.token_transcribe)
        if self.options.without_timestamps:
            seq.append(v.token_not)
        return seq

    def _initial_tokens(self) -> List[int]:
        tokens = list(self.sot_sequence)
        if self.options.prefix is not None:
            # openai's arithmetic, negative max_prefix_len included
            max_prefix_len = self.config.n_text_ctx // 2 - self.sample_len
            tokens = tokens + list(self.options.prefix)[-max_prefix_len:]
        if self.options.prompt is not None and len(self.options.prompt) > 0:
            prompt = list(self.options.prompt)
            tokens = ([self.vocab.token_prev]
                      + prompt[-(self.config.n_text_ctx // 2 - 1):] + tokens)
        return tokens


def decode_full(decoder: TextDecoder, vocab: WhisperVocab, cross_k, cross_v,
                options: DecodingOptions) -> List[DecodingResult]:
    """Decode encoded windows (cross memory (L, B, H, D, Ta), float or
    ``QuantKV``) greedily, or by sampling at ``options.temperature``, one
    result per window."""
    if options.beam_size is not None or (options.best_of or 1) != 1:
        raise NotImplementedError("beam search and best_of are not ported yet")
    return _decode_full_device(decoder, vocab, cross_k, cross_v, options)


def _device_decode_prologue(config: WhisperConfig, vocab: WhisperVocab,
                            options: DecodingOptions, n_rows: int,
                            device: torch.device | str):
    """Masks, tiled and bucketed prompt rows, timestamp cap, and openai's
    context budget: up to n_text_ctx - true_len + 1 tokens are sampled."""
    from .device_loop import build_masks

    task = DecodingTask(config, vocab, options)
    sup_mask, blank_mask = build_masks(vocab, device, suppress_tokens=options.suppress_tokens)
    if not options.suppress_blank:
        blank_mask = torch.zeros_like(blank_mask)
    init = np.tile(np.array(task.initial_tokens, np.int64), (n_rows, 1))
    padded, true_len = _pad_to_bucket(init)
    max_initial_index = None
    if options.max_initial_timestamp is not None and not options.without_timestamps:
        max_initial_index = round(options.max_initial_timestamp / 0.02)
    sample_len = max(0, min(task.sample_len, config.n_text_ctx - true_len + 1))
    return task, padded, true_len, sup_mask, blank_mask, max_initial_index, sample_len


def _greedy_device_results(toks, lengths, sum_lp, nosp, vocab: WhisperVocab,
                           temperature: float) -> List[DecodingResult]:
    """DecodingResults on the host (avg_logprob over len + 1, as openai)."""
    toks, lengths, sum_lp, nosp = (t.cpu().numpy() for t in (toks, lengths, sum_lp, nosp))
    results = []
    for i in range(toks.shape[0]):
        seq = [int(t) for t in toks[i, : lengths[i]]]
        text = vocab.decode(seq).strip()
        results.append(DecodingResult(
            tokens=seq, text=text,
            avg_logprob=float(sum_lp[i]) / (len(seq) + 1),
            no_speech_prob=float(nosp[i]),
            temperature=temperature,
            compression_ratio=compression_ratio(text),
        ))
    return results


def _decode_full_device(decoder: TextDecoder, vocab: WhisperVocab, cross_k, cross_v,
                        options: DecodingOptions) -> List[DecodingResult]:
    from .device_loop import decode_segment_device

    config = decoder.cfg
    n_audio = _cross_batch(cross_k)
    device = getattr(cross_k, "data", cross_k).device
    (task, padded, true_len, sup_mask, blank_mask, max_initial_index,
     sample_len) = _device_decode_prologue(config, vocab, options, n_audio, device)
    # The segment never outgrows prefill + sample budget.
    cache = init_cache(config, n_audio, dtype=_cache_dtype(cross_k), device=device,
                       ctx=padded.shape[1] + sample_len + 8)
    generator = None
    if options.temperature > 0.0:
        generator = torch.Generator(device=device).manual_seed(options.seed)
    toks, lengths, sum_lp, nosp = decode_segment_device(
        decoder, torch.from_numpy(padded).to(device), true_len, task.sot_index,
        cache, cross_k, cross_v, sup_mask, blank_mask, sample_len=sample_len,
        use_timestamps=not options.without_timestamps,
        max_initial_index=max_initial_index, temperature=options.temperature,
        generator=generator,
    )
    return _greedy_device_results(toks, lengths, sum_lp, nosp, vocab, options.temperature)
