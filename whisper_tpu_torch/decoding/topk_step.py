"""The device rules + top-k decode step of the host-orchestrated beam.

Port of ``whisper_tpu/decoding/topk_step.py``. Beam search keeps its
bookkeeping on the host (hypothesis sets are irregular), but the host loop
would fetch the full (n_seq, n_vocab) logits every step. Here the step
applies the device loop's rule grammar on the device and returns only the
top (beam_size + 1) log-probabilities and token ids, exactly what openai's
beam update consumes. The rules read per-row state (last and previous
token, last timestamp, step index) that the host mirrors from its token
history (``rule_state_from_tokens``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..io.vocab import device_special_ids
from ..model.decoder import KVCache, TextDecoder, decode_step
from .device_loop import RuleState, _apply_rules_device


def vocab_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last axis and their ids, ties broken
    toward the lower id, as ``lax.top_k`` (and JAX's blocked ``vocab_topk``)
    breaks them: a stable descending sort keeps equal values in id order.
    (JAX's blocking is a TPU layout device; the selection is the same.)"""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def decode_step_topk(
    decoder: TextDecoder,
    tokens: torch.Tensor,          # (n_seq, T) tokens to feed this step
    n_past: int,
    cache: KVCache,
    cross_k, cross_v,
    suppress_mask: torch.Tensor, blank_mask: torch.Tensor,
    last_tok: torch.Tensor, prev_tok: torch.Tensor, last_ts: torch.Tensor,  # (n_seq,)
    step: int,                     # sampled-token count so far
    k: int,
    use_timestamps: bool = True,
    max_initial_index: Optional[int] = 50,
):
    """One forward, then the rules and the top-k on the device. Returns
    (top-k log-probabilities (n, k) f32, their ids (n, k), the EOT
    log-probability (n, 1), the cache updated in place)."""
    v = decoder.cfg.n_vocab
    eot, beg, not_, _ = device_special_ids(v)
    logits, cache = decode_step(decoder, tokens, n_past, cache, cross_k, cross_v)
    filt = _apply_rules_device(logits[:, -1].float(), step, RuleState(last_tok, prev_tok, last_ts),
                               suppress_mask, blank_mask, (eot, beg, not_, v), use_timestamps,
                               max_initial_index)
    logprobs = torch.log_softmax(filt, dim=-1)
    top_lp, top_ids = vocab_topk(logprobs, k)
    return top_lp, top_ids, logprobs[:, eot:eot + 1], cache


def rule_state_from_tokens(tokens: np.ndarray, sample_begin: int, beg: int,
                           device: torch.device | str = "cpu"):
    """The host's mirror of the device rule state from the token history
    (n, T): (last_tok, prev_tok, last_ts) (n,) on ``device``, -1 where
    there is none, and the number of sampled tokens."""
    n = tokens.shape[0]
    last_tok = np.full(n, -1, np.int64)
    prev_tok = np.full(n, -1, np.int64)
    last_ts = np.full(n, -1, np.int64)
    sampled = tokens[:, sample_begin:]
    if sampled.shape[1] >= 1:
        last_tok = sampled[:, -1].astype(np.int64)
    if sampled.shape[1] >= 2:
        prev_tok = sampled[:, -2].astype(np.int64)
    for i in range(n):
        ts = sampled[i][sampled[i] >= beg]
        if ts.size:
            last_ts[i] = ts[-1]
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(last_tok), to(prev_tok), to(last_ts), int(sampled.shape[1])
