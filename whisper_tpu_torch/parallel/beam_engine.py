"""Beam search under continuous batching: a slot pool of beam GROUPS.

Port of ``whisper_tpu/parallel/beam_engine.py`` on one device. The greedy
``SlotEngine`` (engine.py) admits one stream per slot row; here a slot is a
group of ``beam_size`` physical rows sharing one stream's encoder memory
(group-shared cross attention: the decoder folds the beam axis into the
query axis, ``model.decoder``). Groups decode in chunks, each at its own
position (a ragged ``n_past``, one value for the k rows of a group), each
step running the device beam's semantics (``decoding.device_beam``): rules
and top-(k+1) in physical row order, openai's stable-sort bookkeeping per
group (``beam_update`` with a (G,) step), copy-on-write row reassignment
(``cow_assign``) and EOT routing into per-group finished sets. A finished
group's slot is refilled between chunks without touching its neighbours.

What differs from JAX, by design: the fork copies happen IN PLACE every
step, with the kernel K7 (``kernels.beam_gather.cow_copy_rows``) over the
pool's leaves, as the device beam does. JAX keeps the pool read-only for a
whole chunk, composes a fork pointer per row, appends to a per-chunk tail
and permutes and flushes the pool once per chunk (``decode_step_chunk``,
``init_tail``), because under XLA a per-step row update rewrites the whole
multi-GB pool. A PyTorch tensor is updated in place, and K7 moves only the
forked rows (it skips identity rows itself), so the decoder reads the pool
as the greedy engine does (K5 over a float pool, K4 over an int8 one, each
row's ``n_past`` read in device memory). The chunk stops early as the
greedy chunk does (a step-late flag, see ``engine``'s note).

Token-identical to the device beam per stream, and to JAX's
``BeamSlotEngine`` (tests/test_torch_beam_engine.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..decoding.device_beam import beam_update, cow_assign
from ..decoding.device_loop import RuleState, _apply_rules_device
from ..decoding.result import DecodingResult, compression_ratio
from ..decoding.task import DecodingOptions, DecodingTask
from ..io.vocab import device_special_ids
from ..kernels.beam_gather import cache_leaves, cow_copy_rows
from ..kernels.ops import NEG
from ..model.decoder import KVCache, decode_step
from .engine import SlotEngine, _HostCopy, _scatter, _to_device


@dataclasses.dataclass
class BeamEngineState:
    """The group pool, S = n_slots + 1 groups of k rows (the last group is
    the trash group), updated in place."""

    cache_k: object           # (S·k, L, H, D, C) physical rows, float or QuantKV
    cache_v: object
    logits: torch.Tensor      # (S·k, V) f32, physical row order
    phys: torch.Tensor        # (S·k,) int64: physical row per (group, beam)
    last_tok: torch.Tensor    # (S·k,) int64 rule state, physical row order
    prev_tok: torch.Tensor
    last_ts: torch.Tensor
    tokens: torch.Tensor      # (S, k, max_new) int64: active-beam histories (beam order)
    sum_lp: torch.Tensor      # (S, k) f32
    fin_tokens: torch.Tensor  # (S, k, max_new) int64
    fin_scores: torch.Tensor  # (S, k) f32
    fin_len: torch.Tensor     # (S, k) int64
    fin_count: torch.Tensor   # (S,) int64
    n_past: torch.Tensor      # (S,) int32: per-group position
    step: torch.Tensor        # (S,) int32: sampled positions per group
    active: torch.Tensor      # (S,) bool
    no_speech: torch.Tensor   # (S,) f32
    max_new_row: torch.Tensor  # (S,) int32: per-group sample budget
    forks: torch.Tensor       # (2,) int64: forked rows summed over the steps, and the most in one


def _per_row(x: torch.Tensor, k: int) -> torch.Tensor:
    """Each entry of ``x`` (along dim 0) k times in a row, contiguous:
    ``repeat_interleave(k, 0)`` without a host wait for the output size."""
    return x.unsqueeze(1).expand(x.shape[0], k, *x.shape[1:]).reshape(
        x.shape[0] * k, *x.shape[1:])


@torch.inference_mode()
def _decode_chunk_beam(decoder, state: BeamEngineState, cross_k, cross_v, sup_mask, blank_mask,
                       steps: int, k: int, use_timestamps: bool,
                       max_initial_index: Optional[int]) -> int:
    """Up to ``steps`` beam steps of every group, in place; the loop stops
    once no group is active (read a step late). Inactive groups are frozen:
    their bookkeeping stays, their rows fork nothing and decode EOT at an
    unchanged position. Returns the steps run."""
    v = decoder.cfg.n_vocab
    eot, beg, not_, _ = device_special_ids(v)
    st = state
    S = st.active.shape[0]
    Sk = S * k
    dev = st.logits.device
    base = (torch.arange(S, device=dev) * k)[:, None]
    ident = torch.arange(k, device=dev).expand(S, k)
    rows = torch.arange(Sk, device=dev)
    leaves = cache_leaves(KVCache(st.cache_k, st.cache_v))
    flag = None  # the previous step's "any group active", on its way to the host
    ran = 0
    for _ in range(steps):
        if flag is not None and flag.ready() and not flag.get()[0]:
            break
        filt = _apply_rules_device(st.logits, _per_row(st.step, k),
                                   RuleState(st.last_tok, st.prev_tok, st.last_ts), sup_mask,
                                   blank_mask, (eot, beg, not_, v), use_timestamps,
                                   max_initial_index)
        logprobs = torch.log_softmax(filt, dim=-1)
        top_lp_p, top_ids_p = torch.topk(logprobs, k + 1, dim=-1)
        top_lp, top_ids = top_lp_p[st.phys], top_ids_p[st.phys]
        (new_sum_lp, new_tok, new_src, tokens_new,
         fin_t, fin_s, fin_l, fin_c) = beam_update(
            top_lp, top_ids, st.sum_lp, st.tokens, st.fin_tokens, st.fin_scores, st.fin_len,
            st.fin_count, st.step, k, eot)

        # frozen groups keep their bookkeeping and fork nothing
        act = st.active
        a1, a2, actk = act[:, None], act[:, None, None], _per_row(act, k)
        new_src = torch.where(a1, new_src, ident)
        new_phys_l, copy_src_l = cow_assign(st.phys.reshape(S, k) - base, new_src, k)
        new_phys = (new_phys_l + base).reshape(Sk)
        copy_src = (copy_src_l + base).reshape(Sk)
        nt_phys = torch.empty_like(new_phys).scatter_(
            0, new_phys, torch.where(actk, new_tok.reshape(Sk), eot))
        par_last_tok, par_last_ts = st.last_tok[copy_src], st.last_ts[copy_src]

        forked = (copy_src != rows).sum()
        st.forks[0] += forked
        st.forks[1] = torch.maximum(st.forks[1], forked)
        cow_copy_rows(leaves, copy_src)  # K7: fork copies, in place
        lg, _ = decode_step(decoder, nt_phys[:, None], _per_row(st.n_past, k),
                            KVCache(st.cache_k, st.cache_v), cross_k, cross_v)

        st.logits = lg[:, 0].float()
        st.phys = new_phys
        st.prev_tok = torch.where(actk, par_last_tok, st.prev_tok)
        st.last_ts = torch.where(actk, torch.where(nt_phys >= beg, nt_phys, par_last_ts),
                                 st.last_ts)
        st.last_tok = torch.where(actk, nt_phys, st.last_tok)
        st.tokens = torch.where(a2, tokens_new, st.tokens)
        st.sum_lp = torch.where(a1, new_sum_lp, st.sum_lp)
        st.fin_tokens = torch.where(a2, fin_t, st.fin_tokens)
        st.fin_scores = torch.where(a1, fin_s, st.fin_scores)
        st.fin_len = torch.where(a1, fin_l, st.fin_len)
        fin_c = torch.where(act, fin_c, st.fin_count)
        st.fin_count = fin_c
        st.n_past += act.int()
        st.step += act.int()
        st.active = act & (st.step < st.max_new_row) & (fin_c < k)
        flag = _HostCopy([st.active.any()[None]])
        ran += 1
    return ran


def _beam_snapshot(state: BeamEngineState) -> _HostCopy:
    """The harvest arrays (active, step, tokens, sum_lp, fin_tokens,
    fin_scores, fin_len, fin_count, no_speech), on their way to the host."""
    st = state
    return _HostCopy([st.active, st.step, st.tokens, st.sum_lp, st.fin_tokens, st.fin_scores,
                      st.fin_len, st.fin_count, st.no_speech])


@torch.inference_mode()
def _beam_refill(state: BeamEngineState, cross_k_pool, cross_v_pool, groups: torch.Tensor,
                 row_ids: torch.Tensor, ck_rows, cv_rows, cache_k_rows, cache_v_rows,
                 logits_rows, n_inits, max_news, nosp_rows, eot: int) -> None:
    """Install an admission bucket of beam groups, in place: each group's
    prefilled cache row and first logits into its k rows (the k beams start
    from one prompt), the group-shared cross rows, and the group's
    bookkeeping reset. ``groups`` (n,) group indices (trash-padded);
    ``row_ids`` (n·k,) their physical rows, group by group;
    ``n_inits``/``max_news`` (n,) per-group prompt lengths and sample
    budgets."""
    st = state
    trash = st.active.shape[0] - 1
    k = st.sum_lp.shape[1]
    for j in range(k):  # each group's prefilled row into its k rows
        _scatter(st.cache_k, 0, row_ids[j::k], cache_k_rows)
        _scatter(st.cache_v, 0, row_ids[j::k], cache_v_rows)
        st.logits.index_copy_(0, row_ids[j::k], logits_rows)
    _scatter(cross_k_pool, 1, groups, ck_rows)
    _scatter(cross_v_pool, 1, groups, cv_rows)
    st.phys.index_copy_(0, row_ids, row_ids)
    # index_fill_ and fill_ take the value as a scalar argument; assigning a
    # Python number through indexing copies it to the card and waits
    for t in (st.last_tok, st.prev_tok, st.last_ts):
        t.index_fill_(0, row_ids, -1)
    sum_lp0 = st.sum_lp.new_full((groups.shape[0], k), NEG)
    sum_lp0[:, 0].fill_(0.0)
    st.sum_lp.index_copy_(0, groups, sum_lp0)
    st.tokens.index_fill_(0, groups, eot)
    st.fin_tokens.index_fill_(0, groups, eot)
    st.fin_scores.index_fill_(0, groups, NEG)
    st.fin_len.index_fill_(0, groups, 0)
    st.fin_count.index_fill_(0, groups, 0)
    st.n_past.index_copy_(0, groups, n_inits)
    st.step.index_fill_(0, groups, 0)
    st.active.index_fill_(0, groups, True)
    st.active[trash:].fill_(False)
    st.no_speech.index_copy_(0, groups, nosp_rows)
    st.max_new_row.index_copy_(0, groups, max_news)


class BeamSlotEngine(SlotEngine):
    """Continuous-batching BEAM transcription over a pool of beam groups.

    The greedy ``SlotEngine``'s restrictions give way to openai's beam
    semantics (beam_size candidates and a finished set, ranked at the
    finalize), identical per stream to ``decoding.task``'s device beam.
    ``transcribe_many`` serves independent windows of up to 30 s;
    ``transcribe_streams`` (the inherited scheduler, through the hooks
    below) runs whisper_full's sliding-window loop per stream: window
    continuation with prompt carry, the no-speech gate, and escalation
    through the t > 0 best_of rungs, as the offline pipeline's beam
    configuration does."""

    def __init__(self, model, n_slots: int = 8, options: Optional[DecodingOptions] = None,
                 chunk_steps: int = 8, max_new_tokens: Optional[int] = None,
                 quantize: bool = False, mesh=None, admit_buckets=None,
                 schedule: str = "overlapped", audio_ctx: Optional[int] = None):
        options = options or DecodingOptions(beam_size=5)
        if not options.beam_size or options.beam_size < 2:
            raise ValueError("BeamSlotEngine needs options.beam_size >= 2")
        if options.patience is not None:
            raise ValueError(
                "patience enlarges the finished set past beam_size; the device beam keeps "
                "exactly beam_size candidates: use the host beam (decode_full "
                "use_device_loop=False) for patience")
        self.beam_size = options.beam_size
        # SlotEngine.__init__ refuses beam options: give it the greedy twin
        super().__init__(model, n_slots=n_slots,
                         options=dataclasses.replace(options, beam_size=None),
                         chunk_steps=chunk_steps, max_new_tokens=max_new_tokens,
                         quantize=quantize, mesh=mesh, admit_buckets=admit_buckets,
                         schedule=schedule, audio_ctx=audio_ctx)
        self.options = options
        self.ranker = DecodingTask(self.cfg, self.vocab, options).ranker

    # -- long-form scheduler hooks (a slot is a beam group) --

    def _check_stream_options(self, topts) -> None:
        if (topts.beam_size or 0) != self.beam_size:
            raise ValueError(
                f"BeamSlotEngine streams need options.beam_size == {self.beam_size} (the "
                f"engine's group width); got {topts.beam_size!r}")
        if topts.patience is not None:
            raise ValueError("patience is unsupported on the device beam; use "
                             "pipeline.transcribe with use_device_loop=False")
        self._check_common_stream_options(topts)

    def _stream_chunk_snapshot(self, topts) -> _HostCopy:
        """Run one decode chunk, count its steps (``decode_steps``) and start
        the copy of the harvest arrays."""
        ran = _decode_chunk_beam(
            self.model.decoder, self._state, self._cross_pool_k, self._cross_pool_v,
            self.sup_mask, self.blank_mask, self.chunk_steps, self.beam_size,
            not topts.without_timestamps, self.max_initial_index)
        self.steps_run += ran
        self.spans.count("decode_steps", ran)
        return _beam_snapshot(self._state)

    def _stream_result(self, s: int, pulled) -> DecodingResult:
        (_active, step, tokens, sum_lp, fin_t, fin_s, fin_l, fin_c, nosp) = pulled
        return self._finalize_group(s, step, tokens, sum_lp, fin_t, fin_s, fin_l, fin_c, nosp)

    # -- admission --

    def _init_state(self, cache_dtype) -> None:
        S, k, cfg, dev = self.n_slots + 1, self.beam_size, self.cfg, self.device
        cache = self._fresh_cache(S * k, cache_dtype)
        eot = device_special_ids(cfg.n_vocab)[0]

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        self._state = BeamEngineState(
            cache_k=cache.k, cache_v=cache.v,
            logits=full((S * k, cfg.n_vocab), 0.0, torch.float32),
            phys=torch.arange(S * k, device=dev),
            last_tok=full((S * k,), -1, torch.long), prev_tok=full((S * k,), -1, torch.long),
            last_ts=full((S * k,), -1, torch.long),
            tokens=full((S, k, self.max_new), eot, torch.long),
            sum_lp=full((S, k), 0.0, torch.float32),
            fin_tokens=full((S, k, self.max_new), eot, torch.long),
            fin_scores=full((S, k), NEG, torch.float32),
            fin_len=full((S, k), 0, torch.long), fin_count=full((S,), 0, torch.long),
            n_past=full((S,), 0, torch.int32), step=full((S,), 0, torch.int32),
            active=full((S,), False, torch.bool), no_speech=full((S,), 0.0, torch.float32),
            max_new_row=full((S,), self.max_new, torch.int32),
            forks=full((2,), 0, torch.long))
        self.steps_run = 0

    def fork_stats(self) -> dict:
        """Decode steps run since the pool was made, the forked rows (K7's
        copies) summed over them, and the most in one step. Reads the
        device counters: a wait on the card. The steps are ``steps_run``,
        not ``stats["decode_steps"]``: they must share the fork counters'
        lifetime, the pool's, while ``stats`` restarts with each run of a
        scheduler."""
        total, most = (self._state.forks.tolist() if self._state is not None else (0, 0))
        return {"steps": self.steps_run, "forked_rows": total, "max_forked_rows": most,
                "rows": (self.n_slots + 1) * self.beam_size}

    # _encode_bucket is INHERITED: a bucket is encoded and prefilled as the
    # greedy engine does, one row per group, since the k beams of a group
    # start from the same prompt against the same cross memory;
    # _install_rows copies each group's row into its k rows.

    def _install_rows(self, staged: dict, slot_list, rows) -> None:
        """Scatter payload groups ``rows`` of a staged bucket into the groups
        ``slot_list`` (1:1); unselected payload groups land in the trash
        group."""
        k = self.beam_size
        groups = np.full((staged["bucket"],), self.n_slots, np.int64)
        groups[np.asarray(rows, np.int64)] = np.asarray(slot_list, np.int64)
        row_ids = (groups[:, None] * k + np.arange(k)[None]).reshape(-1)
        ids = _to_device(np.concatenate([groups, row_ids]), self.device)
        _beam_refill(self._state, self._cross_pool_k, self._cross_pool_v, ids[: len(groups)],
                     ids[len(groups):], staged["ck"], staged["cv"], staged["cache"].k,
                     staged["cache"].v, staged["logits"], staged["lengths"].to(torch.int32),
                     staged["max_news"].to(torch.int32), staged["nosp"],
                     device_special_ids(self.cfg.n_vocab)[0])

    # transcribe_many and transcribe_streams are INHERITED: SlotEngine's
    # schedulers drive the beam chunk, snapshot and finalize through the
    # hooks above (server.EngineServer runs the same _schedule_streams).

    def _finalize_group(self, g, step, tokens, sum_lp, fin_t, fin_s, fin_l, fin_c,
                        nosp) -> DecodingResult:
        """openai's finalize, as ``decoding.task``'s device beam: finished
        sequences first, padded from the in-flight beams by score, ranked."""
        k = self.beam_size
        seqs: List[List[int]] = []
        lps: List[float] = []
        for i in range(int(fin_c[g])):
            seqs.append([int(t) for t in fin_t[g, i, : int(fin_l[g, i])]])
            lps.append(float(fin_s[g, i]))
        if len(seqs) < k:
            for i in np.argsort(-sum_lp[g]):
                if len(seqs) >= k:
                    break
                seqs.append([int(t) for t in tokens[g, int(i), : int(step[g])]])
                lps.append(float(sum_lp[g, int(i)]))
        sel = self.ranker.rank([seqs], [lps])[0]
        toks = seqs[sel]
        text = self.vocab.decode(toks).strip()
        return DecodingResult(tokens=toks, text=text, avg_logprob=lps[sel] / (len(toks) + 1),
                              no_speech_prob=float(nosp[g]), temperature=0.0,
                              compression_ratio=compression_ratio(text))
