"""openai's decoding rules for one window's sampled tokens, and the gap of a
served token below the reference's choice.

``forbidden`` masks, for every sampled position at once, what openai's
SuppressTokens, SuppressBlank and ApplyTimestampRules forbid given the
tokens before it (timestamps on, ``max_initial_timestamp`` 1.0 s). The last
rule, "sample a timestamp when the timestamps' total probability beats every
text token", is a threshold on the logits: ``gaps`` prices it as far as the
reference is from the other side of it, so a token served on the other
side of a near-tie reads that small distance, not an infinite one.
"""

from __future__ import annotations

from typing import List

import torch

from .special import Special

MAX_INITIAL_INDEX = 50  # round(1.0 / 0.02)


def forbidden(sampled: List[int], sp: Special, device) -> torch.Tensor:
    """(T, V) bool: True where the rules forbid a token at sampled
    position j, given sampled[:j]."""
    T, V, beg = len(sampled), sp.n_vocab, sp.beg
    ids = torch.arange(V, device=device)
    out = torch.zeros((T, V), dtype=torch.bool, device=device)
    out[:, sp.never_sampled()] = True
    out[:, sp.no_timestamps] = True
    last_ts = None
    for j in range(T):
        row = out[j]
        if j == 0:
            row[sp.eot] = True                   # SuppressBlank (no blank token)
            row[:beg] = True                     # a timestamp first
            row[beg + MAX_INITIAL_INDEX + 1:] = True
        else:
            last_was = sampled[j - 1] >= beg
            penult_was = j < 2 or sampled[j - 2] >= beg
            if last_was and penult_was:
                row[beg:] = True
            elif last_was:
                row[: sp.eot] = True
            if last_ts is not None:
                lo = last_ts if (last_was and not penult_was) else last_ts + 1
                row[(ids >= beg) & (ids < lo)] = True
        if sampled[j] >= beg:
            last_ts = sampled[j]
    return out


def _split(logits: torch.Tensor, forbid: torch.Tensor, beg: int):
    lp = torch.log_softmax(logits.float().masked_fill(forbid, float("-inf")), dim=-1)
    ts_mass = torch.logsumexp(lp[:, beg:], dim=-1)
    max_text = lp[:, :beg].max(dim=-1).values
    return lp, ts_mass, max_text


def gaps(logits: torch.Tensor, forbid: torch.Tensor, served: torch.Tensor, beg: int
         ) -> torch.Tensor:
    """(T,) how far each served token's log-probability lies below the
    reference's choice: inf where a rule forbids it; where the mass rule
    stands between them, the larger of the distance to its threshold and
    the gap among what stays allowed, whichever side is nearer."""
    lp, s, m = _split(logits, forbid, beg)
    lt = lp.gather(1, served[:, None])[:, 0]
    best_all = lp.max(dim=-1).values
    best_ts = lp[:, beg:].max(dim=-1).values
    force = s > m
    flip_to_text = torch.maximum(s - m, best_all - lt)       # the rule must fall
    as_ts = torch.minimum(best_ts - lt, flip_to_text)        # a timestamp served
    to_ts = torch.maximum(m - s, best_ts - lt)               # the rule must rise
    g_text = torch.where(force, flip_to_text, best_all - lt)
    g_ts = torch.where(force, as_ts, torch.minimum(best_all - lt, to_ts))
    g = torch.where(served < beg, g_text, g_ts)
    return torch.where(torch.isinf(lt), torch.full_like(g, float("inf")), g)


def picks(logits: torch.Tensor, forbid: torch.Tensor, beg: int) -> torch.Tensor:
    """(T,) the token greedy decoding takes under the rules."""
    lp, s, m = _split(logits, forbid, beg)
    text = torch.arange(lp.shape[-1], device=lp.device) < beg
    return lp.masked_fill((s > m)[:, None] & text[None, :], float("-inf")).argmax(dim=-1)

