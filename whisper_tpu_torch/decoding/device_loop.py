"""Greedy/sampling decode of a batch of segments, on the model's device.

Port of ``whisper_tpu/decoding/device_loop.py``: prefill, the no-speech
probability at the SOT position, the suppress and blank masks, openai's
timestamp grammar and probability-mass rule vectorised over the vocab, then
greedy argmax (or sampling from an explicit ``torch.Generator``). JAX's
``lax.while_loop`` becomes a Python loop that reads one flag from the device
per step, to stop once every row has hit EOT.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.vocab import device_special_ids
from ..kernels.ops import NEG
from ..model.decoder import KVCache, TextDecoder, decode_step


class RuleState(NamedTuple):
    last_tok: torch.Tensor  # (B,) last sampled token, -1 before the first
    prev_tok: torch.Tensor  # (B,) the one before it
    last_ts: torch.Tensor   # (B,) last sampled timestamp token, -1 if none


def _apply_rules_device(
    logits: torch.Tensor,          # (B, V) f32
    step,                          # int, or (B,) int tensor: 0 at the first sampled position
    state: RuleState,
    suppress_mask: torch.Tensor,   # (V,) bool: True = never sample
    blank_mask: torch.Tensor,      # (V,) bool: suppressed at step 0 only
    vocab_consts: Tuple[int, int, int, int],
    use_timestamps: bool,
    max_initial_index: Optional[int],
) -> torch.Tensor:
    """openai's logit rules over a batch. ``step`` is one int for every row
    (the device loop) or a (B,) tensor of each row's own step (the engine's
    slots): the step-0 blank suppression, the first timestamp's bounds and
    the pairing's start apply per row, with no host read of the tensor."""
    eot, beg, not_, _ = vocab_consts
    ids = torch.arange(logits.shape[-1], device=logits.device)[None, :]
    per_row = isinstance(step, torch.Tensor)
    if per_row:
        step = step.reshape(-1, 1)

    def at_first(mask: torch.Tensor) -> Optional[torch.Tensor]:
        """``mask`` (.., V) where the row is at step 0, or None if none is."""
        if per_row:
            return (step == 0) & mask
        return mask if step == 0 else None

    def fill(lg: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        return lg if mask is None else lg.masked_fill(mask, NEG)

    logits = logits.masked_fill(suppress_mask[None, :], NEG)
    logits = fill(logits, at_first(blank_mask[None, :]))

    if use_timestamps:
        logits[:, not_] = NEG
        last_was = state.last_tok >= beg
        if per_row:
            penult_was = (step[:, 0] < 2) | (state.prev_tok >= beg)
        else:
            penult_was = (torch.ones_like(last_was) if step < 2
                          else state.prev_tok >= beg)
        is_ts = ids >= beg
        is_text = ids < eot
        # pair closed -> no timestamps; pair open -> no text
        logits = logits.masked_fill((last_was & penult_was)[:, None] & is_ts, NEG)
        logits = logits.masked_fill((last_was & ~penult_was)[:, None] & is_text, NEG)
        # non-decreasing: mask [beg, last_allowed)
        seen_ts = state.last_ts >= beg
        last_allowed = torch.where(last_was & ~penult_was, state.last_ts, state.last_ts + 1)
        logits = logits.masked_fill(
            seen_ts[:, None] & is_ts & (ids < last_allowed[:, None]), NEG)
        # the first sampled token is a timestamp, at most max_initial
        logits = fill(logits, at_first(ids < beg))
        if max_initial_index is not None:
            logits = fill(logits, at_first(ids > beg + max_initial_index))
        # probability-mass rule
        logprobs = torch.log_softmax(logits, dim=-1)
        ts_mass = torch.logsumexp(logprobs.masked_fill(~is_ts, NEG), dim=-1)
        max_text = logprobs.masked_fill(is_ts, NEG).max(dim=-1).values
        force_ts = ts_mass > max_text
        logits = logits.masked_fill(force_ts[:, None] & (ids < beg), NEG)
    return logits


def decode_segment_device(
    decoder: TextDecoder,
    init_tokens: torch.Tensor,    # (B, P) right-padded prompt+sot sequence
    init_len: int,                # true prefill length (shared)
    sot_index: int,
    cache: KVCache,
    cross_k: torch.Tensor,
    cross_v: torch.Tensor,
    suppress_mask: torch.Tensor,
    blank_mask: torch.Tensor,
    sample_len: int,
    use_timestamps: bool = True,
    max_initial_index: Optional[int] = 50,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
):
    """Returns (tokens (B, sample_len), lengths, sum_logprobs, no_speech_probs).

    ``temperature > 0`` samples with ``generator`` (on the tensors' device),
    which must be given; it cannot reproduce ``jax.random``'s draws."""
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling at temperature > 0 needs a torch.Generator")
    eot, beg, not_, nosp = device_special_ids(decoder.cfg.n_vocab)
    consts = (eot, beg, not_, decoder.cfg.n_vocab)
    B = init_tokens.shape[0]
    dev = init_tokens.device

    logits_all, cache = decode_step(decoder, init_tokens, 0, cache, cross_k, cross_v)
    no_speech_probs = torch.softmax(logits_all[:, sot_index], dim=-1)[:, nosp]
    logits = logits_all[:, init_len - 1]

    tokens_out = torch.full((B, sample_len), eot, dtype=torch.long, device=dev)
    state = RuleState(*(torch.full((B,), -1, dtype=torch.long, device=dev) for _ in range(3)))
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    length = torch.zeros(B, dtype=torch.long, device=dev)
    sum_logprobs = torch.zeros(B, dtype=torch.float32, device=dev)
    n_past = init_len
    for step in range(sample_len):
        filt = _apply_rules_device(logits, step, state, suppress_mask, blank_mask,
                                   consts, use_timestamps, max_initial_index)
        logprobs = torch.log_softmax(filt, dim=-1)
        if temperature == 0.0:
            nxt = torch.argmax(filt, dim=-1)
        else:
            probs = torch.softmax(filt / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        step_lp = logprobs.gather(1, nxt[:, None])[:, 0]
        nxt = torch.where(finished, eot, nxt)
        now_finished = finished | (nxt == eot)
        sum_logprobs = sum_logprobs + torch.where(finished, 0.0, step_lp)
        length = length + (~now_finished).long()
        tokens_out[:, step] = nxt
        is_ts = (nxt >= beg) & ~now_finished
        state = RuleState(last_tok=nxt, prev_tok=state.last_tok,
                          last_ts=torch.where(is_ts, nxt, state.last_ts))
        finished = now_finished
        # JAX forwards the sampled token even after the last step or once
        # every row is done; those logits are never read, so skip them.
        if step + 1 == sample_len or bool(finished.all()):
            break
        lg, cache = decode_step(decoder, nxt[:, None], n_past, cache, cross_k, cross_v)
        logits = lg[:, 0]
        n_past += 1
    return tokens_out, length, sum_logprobs, no_speech_probs


def build_masks(vocab, device: torch.device | str,
                suppress_tokens: Optional[Sequence[int]] = (-1,)
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (V,) suppression and blank masks on ``device``.

    ``suppress_tokens`` follows openai's spec (-1 expands to the non-speech
    tokens; a falsy spec suppresses nothing, as the host filters do)."""
    from .rules import build_suppress_list

    v = vocab.n_vocab
    sup = np.zeros(v, bool)
    if suppress_tokens:
        sup[build_suppress_list(vocab, suppress_tokens)] = True
    blank = np.zeros(v, bool)
    blank_tok = vocab.token_to_id.get(b" ")
    if blank_tok is not None:
        blank[blank_tok] = True
    blank[vocab.token_eot] = True
    return torch.from_numpy(sup).to(device), torch.from_numpy(blank).to(device)
