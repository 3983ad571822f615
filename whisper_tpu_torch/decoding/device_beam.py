"""Beam search decode loop on the model's device.

Port of ``whisper_tpu/decoding/device_beam.py``, with openai's update
semantics, token-exact against the host beam (``decoding.sequence.
BeamSearchDecoder`` in ``task.DecodingTask.run``):

  * the candidate set is the top k+1 extensions of each beam, flattened in
    (beam, rank) order and stable-sorted by score, the order python's
    ``sorted`` gives over openai's insertion-ordered dict;
  * at step 0 the beams share one prefix; ``sum_logprobs = [0, -1e30, ...]``
    makes beams 1..k propose nothing, which stands for openai's dedup;
  * EOT candidates go to a finished set in score order, capped at k in
    insertion order;
  * the KV cache is reordered COPY-ON-WRITE: each beam keeps a pointer to
    the physical cache row that holds its history (``phys``); a parent
    selected by one child passes its row on for free, and only the extra
    children of a parent that forks copy its row, into rows freed by
    dropped beams. The copy is the in-place kernel K7
    (``kernels.beam_gather.cow_copy_rows``), launched once per step over
    every leaf of the self cache. It skips identity rows itself, so the loop
    makes no host-side check for a step without forks (the JAX package's
    ``lax.cond`` around its fork copy avoided XLA's layout copies, which a
    PyTorch tensor does not have).

Logits and the rule state stay in physical-row order; the rules are
row-local, so they apply before any beam-to-row mapping. JAX's
``lax.while_loop`` becomes a Python loop that reads one flag from the device
per step, to stop once every group has k finished sequences.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..io.vocab import device_special_ids
from ..kernels.beam_gather import cache_leaves, cow_copy_rows
from ..kernels.ops import NEG
from ..model.decoder import KVCache, TextDecoder, decode_step
from .device_loop import RuleState, _apply_rules_device


def beam_update(
    top_lp: torch.Tensor,      # (G*k, k+1) candidate logprobs per beam
    top_ids: torch.Tensor,     # (G*k, k+1) candidate token ids per beam
    sum_lp: torch.Tensor,      # (G, k) running beam scores
    tokens: torch.Tensor,      # (G, k, SL) sampled-token history of active beams
    fin_tokens: torch.Tensor,  # (G, k, SL)
    fin_scores: torch.Tensor,  # (G, k)
    fin_len: torch.Tensor,     # (G, k)
    fin_count: torch.Tensor,   # (G,)
    step,                      # int, or (G,) int tensor: the position being sampled
    k: int,
    eot: int,
):
    """One beam-search bookkeeping step (openai update semantics).

    The stable sort of the k(k+1) candidates by score; the first k non-EOT
    become the new beams; EOT candidates go to the finished set only while
    fewer than k non-EOT candidates precede them (openai's break after k
    saved), capped at k in insertion order.

    ``step`` is one int for every group (the device beam) or a (G,) tensor
    on the device with each group's own step (the beam engine's groups,
    JAX's vmapped ``_bu_group``), never read on the host. A group whose
    step is the history's length (a frozen group after its last position)
    writes the last column, as JAX's ``dynamic_update_slice`` clamps its
    start; the beam engine keeps a frozen group's bookkeeping as it was.

    Returns (new_sum_lp, new_tok, new_src, tokens_new,
             fin_tokens, fin_scores, fin_len, fin_count)."""
    G = sum_lp.shape[0]
    GK = G * k
    dev = sum_lp.device
    SL = tokens.shape[-1]

    cand_score = (sum_lp.reshape(GK, 1) + top_lp).reshape(G, k * (k + 1))
    cand_tok = top_ids.reshape(G, k * (k + 1))
    cand_src = torch.arange(k, device=dev).repeat_interleave(k + 1)[None, :].expand(G, -1)

    order = torch.argsort(-cand_score, dim=1, stable=True)  # (G, k(k+1))
    s_score = cand_score.gather(1, order)
    s_tok = cand_tok.gather(1, order)
    s_src = cand_src.gather(1, order)

    is_eot = s_tok == eot
    # Active selection: first k non-EOT candidates in sorted order.
    nf_rank = torch.cumsum(~is_eot, dim=1) - 1
    take_active = ~is_eot & (nf_rank < k)
    slot = torch.where(take_active, nf_rank, k + 1)
    idx_sorted = torch.argsort(slot, dim=1, stable=True)[:, :k]  # (G, k) candidate idx
    new_sum_lp = s_score.gather(1, idx_sorted)
    new_tok = s_tok.gather(1, idx_sorted)
    new_src = s_src.gather(1, idx_sorted)  # (G, k) beam idx

    tokens_new = tokens.gather(1, new_src[:, :, None].expand(-1, -1, SL)).clone()
    if isinstance(step, torch.Tensor):
        col = step.clamp(max=SL - 1).to(torch.long)[:, None, None].expand(G, k, 1)
        tokens_new.scatter_(2, col, new_tok[:, :, None])
        step = step[:, None]  # the finished lengths below, per group
    else:
        tokens_new[:, :, step] = new_tok

    # Finished insertion: an EOT candidate is CONSIDERED only while fewer
    # than k non-EOT candidates precede it; capacity k, insertion order.
    considered = is_eot & (torch.cumsum(~is_eot, dim=1) < k)
    eot_rank = torch.cumsum(considered, dim=1) - 1
    ins_pos = fin_count[:, None] + eot_rank                   # (G, k(k+1))
    accept = considered & (ins_pos < k)
    # Insertion positions of accepted candidates are distinct within a
    # group, so each slot picks its candidate by a one-hot match.
    match = accept[:, :, None] & (ins_pos[:, :, None] == torch.arange(k, device=dev))
    has = match.any(dim=1)                                    # (G, k)
    cand_idx = match.to(torch.uint8).argmax(dim=1)            # first match
    sel_src = s_src.gather(1, cand_idx)
    sel_score = s_score.gather(1, cand_idx)
    hist = tokens.gather(1, sel_src[:, :, None].expand(-1, -1, SL))
    fin_tokens = torch.where(has[:, :, None], hist, fin_tokens)
    fin_scores = torch.where(has, sel_score, fin_scores)
    fin_len = torch.where(has, step, fin_len)
    fin_count = torch.clamp(fin_count + considered.sum(dim=1), max=k)

    return (new_sum_lp, new_tok, new_src, tokens_new,
            fin_tokens, fin_scores, fin_len, fin_count)


def cow_assign(phys: torch.Tensor, new_src: torch.Tensor, k: int):
    """Copy-on-write physical-row assignment for the beam KV cache.

    phys:    (G, k) current group-local physical row per beam;
    new_src: (G, k) group-local source beam per new beam.

    Returns ``(new_phys, copy_src)``, both (G, k): ``new_phys[j]`` is the
    physical row of new beam j (a bijection per group); ``copy_src`` is in
    PHYSICAL-row order, ``copy_src[r]`` the row whose contents row r must
    hold. It equals r except on freshly forked rows, and its sources are
    never destinations (kept rows are never freed rows): the invariant of
    ``kernels.beam_gather.cow_copy_rows``."""
    G = phys.shape[0]
    dev = phys.device
    rr = torch.arange(k, device=dev)
    parent = phys.gather(1, new_src)                                  # (G, k)
    # dup[j]: some j' < j selected the same source beam (the first keeps).
    tri = torch.tril(torch.ones((k, k), dtype=torch.bool, device=dev), -1)
    dup = ((new_src[:, :, None] == new_src[:, None, :]) & tri).any(dim=2)
    keep = ~dup
    # Rows still referenced by a keeper; the rest are free for fork copies.
    used = ((parent[:, :, None] == rr) & keep[:, :, None]).any(dim=1)
    free_rank = torch.cumsum(~used, dim=1) - 1                        # per row
    # rank t -> row index: the t-th free row in ascending order.
    match = (~used)[:, None, :] & (free_rank[:, None, :] == rr[None, :, None])
    free_row = match.to(torch.uint8).argmax(dim=2)                    # (G, k)
    dup_rank = torch.cumsum(dup, dim=1) - 1
    assigned = free_row.gather(1, dup_rank.clamp(0, k - 1))
    new_phys = torch.where(keep, parent, assigned)
    copy_src = torch.zeros((G, k), dtype=parent.dtype, device=dev).scatter(1, new_phys, parent)
    return new_phys, copy_src


class BeamState(NamedTuple):
    phys: torch.Tensor        # (G*k,) physical cache row per beam
    tokens: torch.Tensor      # (G, k, sample_len) sampled tokens of ACTIVE beams
    sum_lp: torch.Tensor      # (G, k)
    last_tok: torch.Tensor    # (G*k,) rule state, PHYSICAL row order
    prev_tok: torch.Tensor
    last_ts: torch.Tensor
    fin_tokens: torch.Tensor  # (G, k, sample_len) finished sequences (without EOT)
    fin_scores: torch.Tensor  # (G, k) sum logprob of finished (-1e30 if empty)
    fin_len: torch.Tensor     # (G, k) token count of finished sequences
    fin_count: torch.Tensor   # (G,)


def beam_decode_device(
    decoder: TextDecoder,
    init_tokens: torch.Tensor,  # (G*k, P) right-padded, identical within a group
    init_len: int,
    sot_index: int,
    cache: KVCache,             # batch G*k, updated in place
    cross_k, cross_v,           # batch G (group-shared) or G*k
    suppress_mask: torch.Tensor,
    blank_mask: torch.Tensor,
    beam_size: int,
    sample_len: int,
    use_timestamps: bool = True,
    max_initial_index: Optional[int] = 50,
):
    """Returns (active_tokens (G,k,SL), active_sum_lp (G,k),
                fin_tokens (G,k,SL), fin_scores (G,k), fin_len (G,k),
                fin_count (G,), steps, no_speech_probs (G,))."""
    v = decoder.cfg.n_vocab
    eot, beg, not_, nosp = device_special_ids(v)
    k = beam_size
    GK = init_tokens.shape[0]
    G = GK // k
    dev = init_tokens.device

    logits_all, cache = decode_step(decoder, init_tokens, 0, cache, cross_k, cross_v)
    no_speech_probs = torch.softmax(logits_all[:, sot_index], dim=-1)[::k, nosp]
    logits = logits_all[:, init_len - 1]

    sum_lp0 = torch.full((G, k), NEG, dtype=torch.float32, device=dev)
    sum_lp0[:, 0] = 0.0
    minus_one = torch.full((GK,), -1, dtype=torch.long, device=dev)
    state = BeamState(
        phys=torch.arange(GK, device=dev),
        tokens=torch.full((G, k, sample_len), eot, dtype=torch.long, device=dev),
        sum_lp=sum_lp0,
        last_tok=minus_one, prev_tok=minus_one, last_ts=minus_one,
        fin_tokens=torch.full((G, k, sample_len), eot, dtype=torch.long, device=dev),
        fin_scores=torch.full((G, k), NEG, dtype=torch.float32, device=dev),
        fin_len=torch.zeros((G, k), dtype=torch.long, device=dev),
        fin_count=torch.zeros((G,), dtype=torch.long, device=dev),
    )
    base = (torch.arange(G, device=dev) * k)[:, None]  # group row offsets
    leaves = cache_leaves(cache)
    n_past = init_len
    step = 0
    while step < sample_len:
        filt = _apply_rules_device(
            logits, step, RuleState(state.last_tok, state.prev_tok, state.last_ts),
            suppress_mask, blank_mask, (eot, beg, not_, v), use_timestamps, max_initial_index)
        logprobs = torch.log_softmax(filt, dim=-1)               # (GK, V), physical rows
        top_lp_p, top_ids_p = torch.topk(logprobs, k + 1, dim=-1)
        # to beam order for the bookkeeping: k+1 values a row
        top_lp, top_ids = top_lp_p[state.phys], top_ids_p[state.phys]
        (new_sum_lp, new_tok, new_src, tokens_new,
         fin_tokens, fin_scores, fin_len, fin_count) = beam_update(
            top_lp, top_ids, state.sum_lp, state.tokens, state.fin_tokens,
            state.fin_scores, state.fin_len, state.fin_count, step, k, eot)

        new_phys_l, copy_src_l = cow_assign(state.phys.reshape(G, k) - base, new_src, k)
        new_phys = (new_phys_l + base).reshape(GK)
        copy_src = (copy_src_l + base).reshape(GK)
        # Rule state per PHYSICAL row: each new beam's token at its row; the
        # parent row's state is at copy_src (its own row when kept).
        nt_phys = torch.empty_like(new_phys).scatter_(0, new_phys, new_tok.reshape(GK))
        state = BeamState(
            phys=new_phys, tokens=tokens_new, sum_lp=new_sum_lp,
            last_tok=nt_phys, prev_tok=state.last_tok[copy_src],
            last_ts=torch.where(nt_phys >= beg, nt_phys, state.last_ts[copy_src]),
            fin_tokens=fin_tokens, fin_scores=fin_scores, fin_len=fin_len,
            fin_count=fin_count,
        )
        step += 1
        # JAX forwards the new tokens even after the last step or once every
        # group is full; those logits are never read, so stop here.
        if step == sample_len or bool((fin_count >= k).all()):
            break
        cow_copy_rows(leaves, copy_src)  # K7: fork copies, in place
        lg, cache = decode_step(decoder, nt_phys[:, None], n_past, cache, cross_k, cross_v)
        logits = lg[:, 0]
        n_past += 1
    return (state.tokens, state.sum_lp, state.fin_tokens, state.fin_scores, state.fin_len,
            state.fin_count, step, no_speech_probs)
