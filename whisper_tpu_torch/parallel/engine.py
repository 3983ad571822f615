"""Continuous-batching serving engine over a fixed slot pool (the SlotEngine).

Port of ``whisper_tpu/parallel/engine.py`` on one device. The engine keeps a
pool of S slots on the card (self-attention KV cache, cross memory, logits,
rule state) and decodes every slot together in chunks of up to
``chunk_steps`` tokens, each slot at its own position: ``n_past`` and
``step`` are (S,) tensors, and the decode step takes them as they are
(``model.decoder``'s ragged path: K5 over a float pool, K4 over an int8
pool, each reading the per-row ``n_past`` in device memory). A finished
slot is refilled between chunks by one indexed scatter per pool leaf.

Admissions are bucketed (16/8/4/2/1 by default): the bucket's audio goes to
the card in one copy (int16 PCM converted there), is windowed into log-mel,
encoded (K1 in every layer; W8A8 with K2/K3 when the encoder weights are
int8), prefilled, and installed into its slots; a partial bucket pads into
the pool's extra trash row. Four host schedules order harvests and
admissions (``pipelined``, ``eager``, ``predictive``, ``overlapped``); they
give the same tokens, which are the device loop's
(``decoding.device_loop``).

What differs from JAX, by design: a chunk is a Python loop over steps. On a
CUDA device each step is the replay of one captured CUDA graph of the whole
step (rules, sampling, the decoder's layers with their kernels, the state
updates), so the host enqueues a step with one launch instead of thousands;
the graph is captured at the first step of each rule setting on each pool,
after that step has run eagerly, and every state field is updated in place
so that a replay and a refill meet at the same addresses. Elsewhere the
same step runs eagerly. JAX's ``while_loop`` stops once no row is active;
here each step copies that flag to the host without waiting and the loop
reads the previous step's copy once it has landed, so the chunk may run a
step past the last active one. An inactive row is frozen (it decodes EOT at
its unchanged position), so the extra step changes no result. The harvest
pull waits only for the snapshot it reads (a CUDA event recorded after its
copy), not for a chunk enqueued after it, and it is the only wait on the
card: host arrays go to the card through pinned memory without a wait, and
a freed admission payload's memory is reused in stream order, so JAX's wait
for the last install before the next encode is not needed to keep one
payload live. One CUDA stream (and a side stream where a graph is warmed up
and captured). No mesh: tensor parallelism is ROADMAP item 16.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from types import SimpleNamespace
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..config import HOP_LENGTH, N_SAMPLES_PER_CHUNK, check_serving_hbm
from ..decoding.device_loop import RuleState, _apply_rules_device, build_masks
from ..decoding.result import DecodingResult, compression_ratio
from ..decoding.task import DecodingOptions, DecodingTask, _pad_to_bucket, decode_full, \
    detect_language
from ..frontend.mel import frame_count, log_mel_spectrogram, mel_window
from ..io.vocab import device_special_ids
from ..kernels.launches import add_launches, kernel_launches
from ..model.decoder import KVCache, decode_step, init_cache
from ..model.encoder import encode
from ..model.quant import QuantKV, fuse_decoder_qkv, init_quant_cache
from ..utils.logging import StageTimers

SCHEDULES = ("pipelined", "eager", "predictive", "overlapped")


@dataclasses.dataclass
class EngineState:
    """The slot pool, S = n_slots + 1 rows (the last is the trash row),
    updated in place."""

    cache_k: object           # (S, L, H, D, C) KV pool, float or QuantKV
    cache_v: object
    logits: torch.Tensor      # (S, V) f32: next-token logits per slot
    n_past: torch.Tensor      # (S,) int32
    step: torch.Tensor        # (S,) int32: sampled tokens so far
    active: torch.Tensor      # (S,) bool
    tokens_out: torch.Tensor  # (S, max_new) int64, -1 where unwritten
    length: torch.Tensor      # (S,) int32
    sum_logprobs: torch.Tensor  # (S,) f32
    last_tok: torch.Tensor    # (S,) int64 rule state
    prev_tok: torch.Tensor
    last_ts: torch.Tensor
    max_new_row: torch.Tensor  # (S,) int32: per-slot sample budget
    no_speech: torch.Tensor   # (S,) f32: P(no-speech) at the window's SOT


def _leaves(pool) -> tuple:
    return tuple(pool) if isinstance(pool, QuantKV) else (pool,)


def _scatter(pool, dim: int, index: torch.Tensor, rows) -> None:
    """pool[..., index, ...] = rows along ``dim``, for each leaf, in place."""
    for p, r in zip(_leaves(pool), _leaves(rows)):
        p.index_copy_(dim, index, r)


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card through pinned memory without
    a wait (the pinned block is held until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class _HostCopy:
    """Copies of device tensors to the host, started now without waiting;
    ``get`` waits for these copies alone (an event recorded after them on
    their card's stream, whatever the calling thread's current device),
    not for work enqueued later."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        device = tensors[0].device
        on_card = device.type == "cuda"
        self.host = [t.to("cpu", non_blocking=True) if on_card else t.clone()
                     for t in tensors]
        self.event = None
        if on_card:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(device))

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def get(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


@torch.inference_mode()
def _decode_step(decoder, state: EngineState, cross_k, cross_v, sup_mask, blank_mask,
                 use_timestamps: bool, max_initial_index: Optional[int]) -> None:
    """One greedy step of every slot. Every field of ``state`` is written in
    place and keeps its storage: a CUDA graph replays this body over fixed
    addresses, and ``_refill_many`` scatters into the tensors it reads.
    Inactive rows are frozen: they decode EOT at their position and advance
    nothing."""
    v = decoder.cfg.n_vocab
    eot, beg, not_, _ = device_special_ids(v)
    st = state
    rows = torch.arange(st.logits.shape[0], device=st.logits.device)
    last_cap = st.tokens_out.shape[1] - 1
    filt = _apply_rules_device(st.logits, st.step, RuleState(st.last_tok, st.prev_tok, st.last_ts),
                               sup_mask, blank_mask, (eot, beg, not_, v), use_timestamps,
                               max_initial_index)
    logprobs = torch.log_softmax(filt, dim=-1)
    nxt = torch.argmax(filt, dim=-1)
    step_lp = logprobs.gather(1, nxt[:, None])[:, 0]
    active = st.active  # written last, after its every read
    nxt = torch.where(active, nxt, eot)
    hit_cap = st.step + 1 >= st.max_new_row
    now_eot = active & ((nxt == eot) | hit_cap)
    st.sum_logprobs += torch.where(active, step_lp, 0.0)
    # a non-EOT token counts toward the transcript even when it is the
    # budget-capped last one (the device loop's sample_len semantics)
    st.length += (active & (nxt != eot)).int()
    pos = st.step.clamp(0, last_cap)
    st.tokens_out[rows, pos] = torch.where(active, nxt, st.tokens_out[rows, pos])
    is_ts = active & ~now_eot & (nxt >= beg)

    lg, _ = decode_step(decoder, nxt[:, None], st.n_past, KVCache(st.cache_k, st.cache_v),
                        cross_k, cross_v)
    st.logits.copy_(lg[:, 0])
    advance = active.int()
    st.n_past += advance
    st.step += advance
    st.prev_tok.copy_(torch.where(active, st.last_tok, st.prev_tok))
    st.last_tok.copy_(torch.where(active, nxt, st.last_tok))
    st.last_ts.copy_(torch.where(is_ts, nxt, st.last_ts))
    st.active &= ~now_eot


def _decode_chunk(step: Callable[[], None], state: EngineState, steps: int) -> int:
    """Up to ``steps`` calls of ``step`` (one greedy step of every slot); the
    loop stops once no row of ``state`` is active, read a step late (see the
    module's note). Returns the steps run."""
    flag = None  # the previous step's "any row active", on its way to the host
    ran = 0
    for _ in range(steps):
        if flag is not None and flag.ready() and not flag.get()[0]:
            break
        step()
        flag = _HostCopy([state.active.any()[None]])
        ran += 1
    return ran


class _GraphHome:
    """Where an engine's step graphs are made on a CUDA device: a side stream,
    which waits for the engine's stream before and is waited for after, and
    one private memory pool that all the engine's live graphs share. No
    method synchronizes: the capture uses ``capture_begin``/``capture_end``
    (``torch.cuda.graph`` synchronizes the device and empties the cache), in
    the thread-local mode, so that other threads (an HTTP front, a profiler)
    may call the runtime meanwhile."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = None

    def release(self) -> None:
        """Forget the pool once every graph in it is gone: the allocator
        frees a pool that no graph holds, and takes no capture into it."""
        self.pool = None

    def warm_up(self, body: Callable[[], None]) -> None:
        """``body`` once, eagerly, on the side stream: the stream's cuBLAS
        workspace and the kernels' one-time set-up happen here, not in the
        capture."""
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            body()
        main.wait_stream(self.stream)

    def capture(self, body: Callable[[], None]) -> "_LockedReplay":
        """``body`` captured as a graph on the side stream; the capture runs
        nothing on the card."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                body()
            finally:
                graph.capture_end()
        main.wait_stream(self.stream)
        return _LockedReplay(graph, self.device)


@functools.cache
def _cu_graph_launch():
    """``cuGraphLaunch`` from libcuda, called with the interpreter's lock held
    (``ctypes.PyDLL``)."""
    fn = ctypes.PyDLL("libcuda.so.1").cuGraphLaunch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class _LockedReplay:
    """A captured graph whose replay launches on the current stream without
    giving up the interpreter's lock. torch's ``replay`` gives it up, and a
    launch in flight on this thread while another thread stops
    ``torch.profiler`` (which holds the lock through its stop) deadlocks
    both: the profiler in its stop, the launch in libcuda, the card idle
    (torch 2.11, CUDA 12.8, a large-v3 step's graph). Holding the lock keeps
    the two apart."""

    def __init__(self, graph: "torch.cuda.CUDAGraph", device: torch.device):
        self.graph = graph  # owns the executable graph
        self.device = device
        self.exec = graph.raw_cuda_graph_exec()

    def replay(self) -> None:
        err = _cu_graph_launch()(self.exec, torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"cuGraphLaunch failed: CUresult {err}")


def _graph_home(device: torch.device) -> Optional[_GraphHome]:
    """The step graphs' home on ``device``: None off CUDA, where the step runs
    eagerly."""
    return _GraphHome(device) if device.type == "cuda" else None


@torch.inference_mode()
def _refill_many(state: EngineState, cross_k_pool, cross_v_pool, slots: torch.Tensor,
                 ck_rows, cv_rows, cache_k_rows, cache_v_rows, logits_rows, init_lens,
                 max_news, nosp_rows) -> None:
    """Install a whole admission bucket: scatter the prefilled KV rows, the
    encoder cross rows and the per-slot state into the rows ``slots``
    ((n,) int64), in place. Entries for the trash row (the last) may repeat;
    it is left inactive."""
    st = state
    trash = st.active.shape[0] - 1
    _scatter(st.cache_k, 0, slots, cache_k_rows)
    _scatter(st.cache_v, 0, slots, cache_v_rows)
    _scatter(cross_k_pool, 1, slots, ck_rows)
    _scatter(cross_v_pool, 1, slots, cv_rows)
    st.logits[slots] = logits_rows
    st.n_past[slots] = init_lens
    # index_fill_ and fill_ take the value as a scalar argument; assigning a
    # Python number through indexing copies it to the card and waits
    st.step.index_fill_(0, slots, 0)
    st.active.index_fill_(0, slots, True)
    st.active[trash:].fill_(False)
    st.length.index_fill_(0, slots, 0)
    st.sum_logprobs.index_fill_(0, slots, 0.0)
    for t in (st.last_tok, st.prev_tok, st.last_ts):
        t.index_fill_(0, slots, -1)
    st.max_new_row[slots] = max_news
    st.no_speech[slots] = nosp_rows


def _mel_windows(audio: torch.Tensor, filters: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(G, n_samples) same-length stacked audio on the device -> (G, n_mels,
    n_frames) windows at offset 0 in one mel pass, each row with its own
    reflect padding and max normalisation. int16 PCM is converted on the
    device (pcm / 32768, the io/wav convention)."""
    if audio.dtype == torch.int16:
        audio = audio.float() / 32768.0
    m = log_mel_spectrogram(audio, filters, frame_count(audio.shape[-1]))
    if m.shape[-1] >= n_frames:
        return m[..., :n_frames]
    return torch.nn.functional.pad(m, (0, n_frames - m.shape[-1]))


@torch.inference_mode()
def _encode_prefill(model, wins, tokens, lengths, sot_idx, quantize: bool, pool_ctx: int,
                    nosp: int):
    """Encode one admission bucket, prefill its prompts, and read each row's
    first logits and no-speech probability."""
    enc = encode(model.encoder, wins, quantize_kv=quantize)
    bucket = wins.shape[0]
    cfg, dev = model.config, wins.device
    if quantize:
        cache = KVCache(*init_quant_cache(cfg, bucket, dev, ctx=pool_ctx))
    else:
        cache = init_cache(cfg, bucket, getattr(enc.cross_k, "data", enc.cross_k).dtype, dev,
                           ctx=pool_ctx)
    logits_all, cache = decode_step(model.decoder, tokens, 0, cache, enc.cross_k, enc.cross_v)
    rows = torch.arange(bucket, device=dev)
    first_logits = logits_all[rows, lengths - 1].float()
    probs_sot = torch.softmax(logits_all[rows, sot_idx].float(), dim=-1)
    return enc.cross_k, enc.cross_v, cache, first_logits, probs_sot[:, nosp]


def _snapshot(state: EngineState) -> _HostCopy:
    """The harvest arrays (active, length, sum_logprobs, tokens_out,
    no_speech), on their way to the host."""
    return _HostCopy([state.active, state.length, state.sum_logprobs, state.tokens_out,
                      state.no_speech])


class SlotEngine:
    """Greedy continuous-batching transcription over a fixed slot pool."""

    # Admission bucket sizes, largest first; each is one encode/prefill shape.
    _ADMIT_BUCKETS = (16, 8, 4, 2, 1)

    def __init__(self, model, n_slots: int = 8, options: Optional[DecodingOptions] = None,
                 chunk_steps: int = 8, max_new_tokens: Optional[int] = None,
                 quantize: bool = False, mesh=None,
                 admit_buckets: Optional[Sequence[int]] = None, schedule: str = "overlapped",
                 audio_ctx: Optional[int] = None):
        """``model`` a ``WhisperModel`` on the card (or on the CPU for
        tests). ``quantize`` keeps the cross pool and the KV pool in int8
        (serving mode; give the model int8 decoder weights with
        ``model.quant.quantize_decoder_weights`` as well)."""
        if mesh is not None:
            raise NotImplementedError(
                "a tensor-parallel SlotEngine needs parallel/{mesh,sharding}.py, which the "
                "port does not have yet (ROADMAP item 16)")
        if options is not None and (options.beam_size or (options.best_of or 1) != 1
                                    or options.temperature != 0):
            raise ValueError("SlotEngine is greedy-only; use decode_full for beams")
        if audio_ctx is not None and not 0 < audio_ctx <= model.config.n_audio_ctx:
            raise ValueError(f"audio_ctx must be in (0, {model.config.n_audio_ctx}]")
        if schedule not in SCHEDULES:
            raise ValueError(
                "schedule must be 'pipelined' (harvest one round late, device always fed), "
                "'eager' (pull the previous snapshot before every admission), 'predictive' "
                "(eager only on rounds where a slot's token budget says it can have "
                "finished), or 'overlapped' (stage the next admission bucket's "
                "encode/prefill behind the in-flight decode chunk and install by scatter as "
                "slots free)")
        self.schedule = schedule
        # the worker's stages: their seconds and the counters are ``stats``
        self.spans = StageTimers()
        self.cfg = model.config
        self.vocab = model.vocab
        self.device = model.device
        self.n_slots = n_slots
        # Unsharded serving fuses each block's Q/K/V into one matmul.
        if "qkv_w" not in model.params["decoder"]["blocks"]:
            model = model.with_params(fuse_decoder_qkv(model.params))
        self.model = model
        self.chunk_steps = chunk_steps
        self.options = options or DecodingOptions()
        self.quantize = quantize

        task = DecodingTask(self.cfg, self.vocab, self.options)
        self.initial_tokens = task.initial_tokens
        self.sot_index = task.sot_index
        self.max_new = max_new_tokens or task.sample_len
        padded, self.init_len = _pad_to_bucket(
            np.tile(np.array(self.initial_tokens, np.int64), (1, 1)))
        self._padded_init = _to_device(padded, self.device)
        # slot-pool context: prefill + generation budget (+ EOT slack)
        self.pool_ctx = min(padded.shape[1] + self.max_new + 8, self.cfg.n_text_ctx)
        self.max_new = min(self.max_new, self.pool_ctx - padded.shape[1])

        sup_mask, blank_mask = build_masks(
            self.vocab, self.device, suppress_tokens=self.options.suppress_tokens)
        if not self.options.suppress_blank:
            blank_mask = torch.zeros_like(blank_mask)
        max_initial_index = None
        if (self.options.max_initial_timestamp is not None
                and not self.options.without_timestamps):
            max_initial_index = round(self.options.max_initial_timestamp / 0.02)
        # transcribe_many restores these: _prepare_streams re-derives the
        # masks from per-call TranscribeOptions
        self._option_masks = (sup_mask, blank_mask, max_initial_index)
        # the rule masks a decode step reads: fixed buffers, which _set_rules
        # fills (a captured step reads them at their addresses)
        self.sup_mask, self.blank_mask = sup_mask.clone(), blank_mask.clone()
        self.max_initial_index = max_initial_index
        # the decode step's CUDA graphs: (use_timestamps, max_initial_index)
        # -> (the pools it was captured over, the graph's replay, its launches)
        self._step_graphs: dict = {}
        self._captures = 0  # the graphs captured over the engine's life

        if admit_buckets is not None:
            self._ADMIT_BUCKETS = tuple(sorted({int(b) for b in admit_buckets}, reverse=True))
        # Engine-wide audio context: every window encodes only the first
        # audio_ctx positions and the cross pools size to it.
        self.audio_ctx = audio_ctx
        self._check_hbm_budget()
        self._n_frames = 2 * (audio_ctx or self.cfg.n_audio_ctx)
        self._cross_pool_k = None  # lazily sized (L, S, H, D, Ta)
        self._cross_pool_v = None
        self._state: Optional[EngineState] = None

    @property
    def stats(self) -> dict:
        """The running totals of the worker's stages and counters: seconds
        as ``<stage>_s`` (admit, chunk, pull, harvest, ...), ``rounds``,
        ``decode_steps`` (the steps the chunks ran), ``graph_steps`` and
        ``graph_captures`` (of those steps, the replays of a captured CUDA
        graph, and the captures; on a CUDA device only), ``encode_windows``,
        ``encode_rows`` and ``encode_buckets`` (the admission buckets' real
        windows, their rows with padding, and the buckets). Each run of a
        scheduler starts a fresh dict."""
        return self.spans.totals

    @stats.setter
    def stats(self, value: dict) -> None:
        self.spans.totals = value

    def _bucket_stage(self, ids: Sequence[int], bucket: int, total=None):
        """The stage of one admission bucket that holds the windows of the
        requests ``ids`` in ``bucket`` rows; counts its windows, rows and
        itself."""
        sp = self.spans
        sp.count("encode_windows", len(ids))
        sp.count("encode_rows", bucket)
        sp.count("encode_buckets")
        return sp.stage("engine.admit.bucket", total, ids=ids, size=bucket)

    def _check_hbm_budget(self, pool_ctx: Optional[int] = None) -> None:
        """config.check_serving_hbm over this engine's geometry (the slot pool
        with its trash row, an admission bucket beside it), against the
        card's memory (unchecked on the CPU), each slot ``beam_size`` rows on
        a beam engine; the estimate is kept in ``hbm_estimate``."""
        beam = getattr(self, "beam_size", None) or 1
        self.hbm_estimate = check_serving_hbm(
            self.cfg, self.n_slots + 1, beam=beam,
            ctx=pool_ctx if pool_ctx is not None else self.pool_ctx,
            kv_dtype_bytes=1 if self.quantize else 2, enc_batch=self._ADMIT_BUCKETS[0],
            engine=True, device=self.device,
            what=f"{type(self).__name__}(n_slots={self.n_slots}, beam={beam}, "
                 f"quantize={self.quantize})")

    # -- stream admission (bucketed: joiners encode and prefill together) --

    def _bucket_for(self, n: int) -> int:
        """The smallest bucket that covers ``n`` (else the largest)."""
        return next((b for b in reversed(self._ADMIT_BUCKETS) if b >= n),
                    self._ADMIT_BUCKETS[0])

    def _window_batch(self, audios: Sequence, bucket: int) -> torch.Tensor:
        """(bucket, n_mels, n_frames) windows for up to ``bucket`` streams
        (zero rows pad the tail): the bucket's audio goes to the card in one
        copy without a wait (int16 stays int16), then one mel pass per
        distinct length. Audio already on the device skips the copy."""
        if all(isinstance(a, torch.Tensor) for a in audios):
            return self._window_batch_device(audios, bucket)
        arrs = [np.asarray(a) for a in audios]
        dtype = np.int16 if all(a.dtype == np.int16 for a in arrs) else np.float32
        arrs = [a.astype(dtype, copy=False) for a in arrs]
        stacked = np.zeros((len(arrs), max(len(a) for a in arrs)), dtype)
        for i, a in enumerate(arrs):
            stacked[i, : len(a)] = a
        audio_dev = _to_device(stacked, self.device)
        return self._window_batch_device([audio_dev[i, : len(a)] for i, a in enumerate(arrs)],
                                         bucket)

    def _window_batch_device(self, audios: Sequence[torch.Tensor], bucket: int) -> torch.Tensor:
        """``_window_batch`` for audio on the device: no host copy, one mel
        pass per distinct length."""
        by_len: dict = {}
        for i, a in enumerate(audios):
            by_len.setdefault(a.shape[0], []).append(i)
        win_rows: List[Optional[torch.Tensor]] = [None] * len(audios)
        for idxs in by_len.values():
            wins_g = _mel_windows(torch.stack([audios[i] for i in idxs]), self.model.filters,
                                  self._n_frames)
            for j, i in enumerate(idxs):
                win_rows[i] = wins_g[j]
        wins = torch.stack(win_rows)
        if len(audios) < bucket:
            wins = torch.cat([wins, wins.new_zeros((bucket - len(audios),) + wins.shape[1:])])
        return wins

    def _fresh_cache(self, batch: int, dtype) -> KVCache:
        if self.quantize:
            return KVCache(*init_quant_cache(self.cfg, batch, self.device, ctx=self.pool_ctx))
        return init_cache(self.cfg, batch, dtype, self.device, ctx=self.pool_ctx)

    def _nosp_token(self) -> int:
        return device_special_ids(self.cfg.n_vocab)[3]

    def _init_state(self, cache_dtype) -> None:
        # One extra TRASH row (index n_slots): bucket installs are always
        # full fixed-size scatters; unused entries land in the trash row.
        S, cfg, dev = self.n_slots + 1, self.cfg, self.device
        cache = self._fresh_cache(S, cache_dtype)

        def full(value, dtype):
            return torch.full((S,), value, dtype=dtype, device=dev)

        self._state = EngineState(
            cache_k=cache.k, cache_v=cache.v,
            logits=torch.zeros((S, cfg.n_vocab), dtype=torch.float32, device=dev),
            n_past=full(0, torch.int32), step=full(0, torch.int32),
            active=full(False, torch.bool),
            tokens_out=torch.full((S, self.max_new), -1, dtype=torch.long, device=dev),
            length=full(0, torch.int32), sum_logprobs=full(0.0, torch.float32),
            last_tok=full(-1, torch.long), prev_tok=full(-1, torch.long),
            last_ts=full(-1, torch.long), max_new_row=full(self.max_new, torch.int32),
            no_speech=full(0.0, torch.float32))

    def _admit_many(self, slots: Sequence[int], audios: Sequence, ids: Sequence[int]) -> None:
        """Admit several streams (requests ``ids``) with shared
        encode/prefill calls, one bucket at a time, without waiting on the
        card (a bucket's payload is freed once its install is enqueued, and
        the next bucket reuses its memory in stream order); each bucket's
        windows and install add to ``stats``' stage_s and install_s."""
        sp = self.spans
        i = 0
        while i < len(slots):
            bucket = self._bucket_for(len(slots) - i)
            n = min(bucket, len(slots) - i)
            with self._bucket_stage(ids[i: i + n], bucket):
                with sp.stage("engine.stage", "stage_s"):
                    wins = self._window_batch(audios[i: i + n], bucket)
                with sp.stage("engine.install", "install_s"):
                    self._install_bucket(list(slots[i: i + n]), wins, bucket)
            i += n

    def _install_bucket(self, slot_list, wins, bucket: int, tokens=None, lengths=None,
                        sot_idx=None, max_news=None) -> None:
        """Encode, prefill and install one admission bucket; a partial bucket
        pads its slot vector with the trash row. Without per-row arguments
        every row prefills the engine's initial tokens (the 30 s path); the
        long-form path passes per-row prompts."""
        staged = self._encode_bucket(wins, bucket, tokens, lengths, sot_idx, max_news)
        self._install_rows(staged, list(slot_list), list(range(len(slot_list))))

    def _encode_bucket(self, wins, bucket: int, tokens=None, lengths=None, sot_idx=None,
                       max_news=None) -> dict:
        """Encode and prefill one admission bucket without binding it to
        slots: the payload carries the cross rows, prefilled KV rows, first
        logits and per-row budgets."""
        dev = self.device
        if tokens is None:
            tokens = self._padded_init.expand(bucket, -1)
            lengths = torch.full((bucket,), self.init_len, dtype=torch.long, device=dev)
            sot_idx = torch.full((bucket,), self.sot_index, dtype=torch.long, device=dev)
        ck, cv, cache, first_logits, nosp = _encode_prefill(
            self.model, wins, tokens, lengths, sot_idx, self.quantize, self.pool_ctx,
            self._nosp_token())
        if max_news is None:
            max_news = torch.full((bucket,), self.max_new, dtype=torch.int32, device=dev)
        self._size_pools(ck, cv)
        return {"bucket": bucket, "ck": ck, "cv": cv, "cache": cache, "logits": first_logits,
                "lengths": lengths, "max_news": max_news, "nosp": nosp}

    def _size_pools(self, ck, cv) -> None:
        """Make the state and the cross pools (one row a slot and the trash
        row, float or QuantKV) at the first staged bucket's dtypes and
        widths, if they do not exist yet."""
        if (self._state is None or self._cross_pool_k is None) and self._step_graphs:
            self._step_graphs.clear()  # they read the old pools; free them first
            self._home.release()
        if self._state is None:
            self._init_state(getattr(ck, "data", ck).dtype)
        if self._cross_pool_k is None:
            def pool_like(row):
                if isinstance(row, QuantKV):
                    return QuantKV(*(pool_like(a) for a in row))
                return row.new_zeros((row.shape[0], self.n_slots + 1) + row.shape[2:])

            self._cross_pool_k = pool_like(ck)
            self._cross_pool_v = pool_like(cv)

    def _install_rows(self, staged: dict, slot_list, rows) -> None:
        """Scatter payload rows ``rows`` of a staged bucket into ``slot_list``
        (1:1); unselected rows land in the trash slot, so a payload can be
        installed across several calls as slots free up."""
        slot_arr = np.full((staged["bucket"],), self.n_slots, np.int64)
        slot_arr[np.asarray(rows, np.int64)] = np.asarray(slot_list, np.int64)
        _refill_many(self._state, self._cross_pool_k, self._cross_pool_v,
                     _to_device(slot_arr, self.device), staged["ck"], staged["cv"],
                     staged["cache"].k, staged["cache"].v, staged["logits"],
                     staged["lengths"].to(torch.int32), staged["max_news"].to(torch.int32),
                     staged["nosp"])

    def _harvest(self, slot: int, tokens_out, length, sum_logprobs, no_speech=None,
                 strip: bool = True) -> DecodingResult:
        """A result from host copies of the state arrays."""
        n = int(length[slot])
        seq = [int(t) for t in tokens_out[slot, :n]]
        sum_lp = float(sum_logprobs[slot])
        text = self.vocab.decode(seq)
        if strip:
            text = text.strip()
        return DecodingResult(
            tokens=seq, text=text, avg_logprob=sum_lp / (len(seq) + 1),
            no_speech_prob=float(no_speech[slot]) if no_speech is not None else 0.0,
            temperature=0.0, compression_ratio=compression_ratio(text))

    # -- the scheduler loop --

    def _pull_and_free(self, snap, slot_req: list, results: list) -> None:
        """Read a round's snapshot (its wait on the card) and free each slot
        whose request finished there, with its result in ``results``."""
        req_map, arrs = snap
        with self.spans.stage("engine.pull", "pull_s"):
            pulled = arrs.get()
        active = pulled[0]
        with self.spans.stage("engine.finish", "harvest_s"):
            for s in range(self.n_slots):
                if req_map[s] >= 0 and not active[s] and slot_req[s] == req_map[s]:
                    results[req_map[s]] = self._stream_result(s, pulled)
                    slot_req[s] = -1

    @torch.inference_mode()
    def transcribe_many(self, audios: Sequence) -> List[DecodingResult]:
        """Drain a queue of independent 30 s-or-shorter streams (numpy f32 or
        int16 PCM, or tensors already on the device); results come back in
        submission order. Slots are refilled as they free up. The loop is
        pipelined one round deep: after enqueuing chunk N the host harvests
        chunk N-1's snapshot, admits into the slots it freed, and only then
        waits on N's snapshot next round. Phase wall times accumulate in
        ``self.stats`` (admit / chunk / pull / harvest seconds, rounds)."""
        # a prior transcribe_streams/warmup re-derived the rule masks from
        # ITS TranscribeOptions; this path decodes with the constructor's
        self._set_rules(*self._option_masks)
        if self.schedule == "overlapped":
            return self._transcribe_many_overlapped(audios)
        queue = list(enumerate(audios))
        results: List[Optional[DecodingResult]] = [None] * len(queue)
        slot_req = [-1] * self.n_slots  # request index per slot
        queue.reverse()  # pop() from the front
        self.stats = {"admit_s": 0.0, "chunk_s": 0.0, "pull_s": 0.0, "rounds": 0,
                      "eager_rounds": 0}
        snap = None  # (req_map, snapshot) of the previous round
        # A slot cannot budget-finish before ceil(max_new / chunk_steps)
        # chunks (schedule "predictive"); EOT can finish it earlier.
        min_rounds = max(1, -(-self.max_new // self.chunk_steps))
        rounds_left = [0] * self.n_slots
        sp = self.spans

        while queue or any(r >= 0 for r in slot_req) or snap is not None:
            if snap is not None and queue and (
                    self.schedule == "eager"
                    or (self.schedule == "predictive"
                        and any(slot_req[s] >= 0 and rounds_left[s] <= 0
                                for s in range(self.n_slots)))):
                self._pull_and_free(snap, slot_req, results)
                snap = None
                self.stats["eager_rounds"] += 1
            join_slots, join_audios = [], []
            for s in range(self.n_slots):
                if slot_req[s] < 0 and queue:
                    idx, audio = queue.pop()
                    join_slots.append(s)
                    join_audios.append(audio)
                    slot_req[s] = idx
            if join_slots:
                with sp.stage("engine.admit", "admit_s"):
                    self._admit_many(join_slots, join_audios,
                                     [slot_req[s] for s in join_slots])
                for s in join_slots:
                    rounds_left[s] = min_rounds
            if any(r >= 0 for r in slot_req):
                with sp.stage("engine.chunk", "chunk_s"):
                    new_snap = (list(slot_req), self._stream_chunk_snapshot(self.options))
                for s in range(self.n_slots):
                    rounds_left[s] -= 1
            else:
                new_snap = None
            if snap is not None:
                self._pull_and_free(snap, slot_req, results)
            snap = new_snap
            self.stats["rounds"] += 1
        return results  # type: ignore[return-value]

    def _transcribe_many_overlapped(self, audios: Sequence) -> List[DecodingResult]:
        """The "overlapped" schedule: the queue head's encode/prefill is
        enqueued during decode rounds (it needs no slot), and installed by
        scatter as slots free; the decode chunk is enqueued before each
        round's pull, which is the only wait on the card. At most one staged
        payload is live: a new encode is enqueued only after the previous
        payload has been installed and dropped, so the encode reuses its
        memory in stream order."""
        queue = list(enumerate(audios))
        results: List[Optional[DecodingResult]] = [None] * len(queue)
        slot_req = [-1] * self.n_slots
        queue.reverse()
        self.stats = {"admit_s": 0.0, "chunk_s": 0.0, "pull_s": 0.0, "rounds": 0,
                      "eager_rounds": 0, "stage_s": 0.0, "install_s": 0.0,
                      "staged_buckets": 0, "partial_installs": 0}
        snap = None
        staged = None  # payload dict + "pending": [(row, req_idx)]
        min_rounds = max(1, -(-self.max_new // self.chunk_steps))
        rounds_left = [0] * self.n_slots
        sp = self.spans

        def stage_next():
            n = min(len(queue), self.n_slots, self._ADMIT_BUCKETS[0])
            if n == 0:
                return None
            bucket = self._bucket_for(n)
            n = min(bucket, n)
            items = [queue.pop() for _ in range(n)]
            with self._bucket_stage([idx for idx, _a in items], bucket, "stage_s"):
                wins = self._window_batch([a for _, a in items], bucket)
                st = self._encode_bucket(wins, bucket)
            self.stats["staged_buckets"] += 1
            st["pending"] = [(row, idx) for row, (idx, _a) in enumerate(items)]
            return st

        def consume_staged():
            nonlocal staged
            while staged is not None:
                free = [s for s in range(self.n_slots) if slot_req[s] < 0]
                if not free:
                    break
                take = staged["pending"][: len(free)]
                with sp.stage("engine.install", "install_s"):
                    self._install_rows(staged, free[: len(take)], [row for row, _ in take])
                for s, (_row, idx) in zip(free, take):
                    slot_req[s] = idx
                    rounds_left[s] = min_rounds
                staged["pending"] = staged["pending"][len(take):]
                if staged["pending"]:
                    self.stats["partial_installs"] += 1
                    break  # slots exhausted; the rest installs as they free
                staged = None
                if queue and len(free) > len(take):
                    staged = stage_next()  # burst: more slots to fill now

        while queue or staged is not None or snap is not None or any(
                r >= 0 for r in slot_req):
            # 0. early pull when some occupied slot's budget says it can have
            #    finished: refills then land before this round's chunk
            if snap is not None and (staged is not None or queue) and any(
                    slot_req[s] >= 0 and rounds_left[s] <= 0 for s in range(self.n_slots)):
                self._pull_and_free(snap, slot_req, results)
                snap = None
                self.stats["eager_rounds"] += 1
                consume_staged()
            # 1. the decode chunk first: the card stays fed through the pull
            if any(r >= 0 for r in slot_req):
                with sp.stage("engine.chunk", "chunk_s"):
                    new_snap = (list(slot_req), self._stream_chunk_snapshot(self.options))
                for s in range(self.n_slots):
                    rounds_left[s] -= 1
            else:
                new_snap = None
            # 2. top up staging (the encode queues behind the chunk)
            if staged is None and queue:
                staged = stage_next()
            # 3. harvest the previous round's snapshot
            if snap is not None:
                self._pull_and_free(snap, slot_req, results)
            snap = new_snap
            # 4. install staged rows into the slots the harvest freed
            consume_staged()
            self.stats["rounds"] += 1
        self.stats["admit_s"] += self.stats["stage_s"] + self.stats["install_s"]
        return results  # type: ignore[return-value]

    # -- long-form streams (whisper_full semantics through the engine) --

    @torch.inference_mode()
    def transcribe_streams(self, audios: Sequence, options=None, **kwargs) -> List[dict]:
        """Continuous-batching long-form transcription: every stream runs the
        30 s sliding-window loop (seek, prompt carry, no-speech gate,
        temperature fallback) while the engine batches windows across
        streams: a slot decodes one window, and a finished window re-queues
        its stream's next one. Segment extraction is
        ``pipeline.transcribe.finish_window``, the gate
        ``gate_needs_fallback``, and a failed window escalates through
        ``decode_full`` at the remaining ladder temperatures, so the output
        is ``pipeline.transcribe``'s. Returns one dict per stream: {text,
        segments, language, duration}."""
        from ..pipeline.transcribe import TranscribeOptions

        topts = options or TranscribeOptions(**kwargs)
        if options is not None and kwargs:
            topts = dataclasses.replace(options, **kwargs)
        self._check_stream_options(topts)
        temps = self._prepare_streams(topts)

        streams = [self._init_stream(i, a, topts) for i, a in enumerate(audios)]
        pending = [st for st in streams if not st["done"]]
        pending.reverse()
        self.stats = {"admit_s": 0.0, "chunk_s": 0.0, "pull_s": 0.0, "fallback_s": 0.0,
                      "rounds": 0, "windows": 0, "fallbacks": 0}

        def finish(s, st, pulled):
            if self._advance_stream(s, st, pulled, topts, temps):
                st["done"] = True
            else:
                pending.append(st)

        self._schedule_streams(topts, [None] * self.n_slots,
                               keep_going=lambda busy: busy or bool(pending),
                               next_stream=lambda: pending.pop() if pending else None,
                               finish=finish)
        return [self._stream_output(st) for st in streams]

    def _schedule_streams(self, topts, slot_stream: list, keep_going, next_stream,
                          finish) -> None:
        """The long-form scheduler, shared by ``transcribe_streams`` (a list
        of streams) and ``server.EngineServer`` (a live queue). Each round:
        ``keep_going(busy)`` (busy: a slot is taken or a harvest is on its
        way) ends the loop when it returns False; free slots take streams
        from ``next_stream()`` (None: none now) and their windows are
        encoded and prefilled bucket by bucket; one decode chunk and the
        copy of its harvest arrays are started; then the PREVIOUS round's
        copy is read, and each slot whose window finished there is freed
        and handed to ``finish(slot, stream, pulled)``. ``slot_stream`` (one
        entry a slot, None when free) is the caller's, so a caller whose
        loop dies still sees the streams in flight. Each round is a stage
        (``engine.round``) holding ``engine.admit``, ``engine.chunk``,
        ``engine.pull`` and ``engine.finish``, which add to ``self.stats``'
        admit_s, chunk_s, pull_s and harvest_s; the caller's hooks add their
        own stages inside the round."""
        # Admission tickets guard the one-round-late harvest: a stale
        # snapshot of a slot that a stream's next window has re-entered must
        # not be harvested as the new window's result.
        slot_ticket = [0] * self.n_slots
        next_ticket = 1
        snap = None
        sp = self.spans
        while True:
            with sp.stage("engine.round", None):
                busy = snap is not None or any(st is not None for st in slot_stream)
                if not keep_going(busy):
                    break
                join = []
                for s in range(self.n_slots):
                    if slot_stream[s] is None:
                        st = next_stream()
                        if st is None:
                            break
                        slot_stream[s] = st
                        slot_ticket[s] = next_ticket
                        next_ticket += 1
                        join.append((s, st))
                if not join and not busy:
                    continue  # idle: nothing admitted, nothing in flight
                if join:
                    with sp.stage("engine.admit", "admit_s"):
                        self._admit_stream_windows(join, topts)
                if any(st is not None for st in slot_stream):
                    with sp.stage("engine.chunk", "chunk_s"):
                        new_snap = (list(slot_stream), list(slot_ticket),
                                    self._stream_chunk_snapshot(topts))
                else:
                    new_snap = None
                if snap is not None:
                    self._harvest_streams(snap, slot_stream, slot_ticket, finish)
                snap = new_snap
                self.stats["rounds"] += 1

    def _harvest_streams(self, snap, slot_stream: list, slot_ticket: list, finish) -> None:
        """Read a round's snapshot (its wait on the card), then free each slot
        whose window finished there and hand it to ``finish``; one
        ``engine.window_done`` stage a window, with its request's id."""
        stream_map, tick_map, arrs = snap
        with self.spans.stage("engine.pull", "pull_s"):
            pulled = arrs.get()
        active = pulled[0]
        with self.spans.stage("engine.finish", "harvest_s"):
            for s in range(self.n_slots):
                st = stream_map[s]
                if (st is None or active[s] or slot_stream[s] is not st
                        or slot_ticket[s] != tick_map[s]):
                    continue
                slot_stream[s] = None
                with self.spans.stage("engine.window_done", None, ids=(st["idx"],)):
                    finish(s, st, pulled)

    def warmup(self, options=None, seconds: float = 2.0) -> "SlotEngine":
        """Run every serving shape once before taking traffic: one
        transcribe_streams run per admission bucket size up to n_slots (and
        n_slots itself), so the first request meets warm kernel builds and
        allocator pools. A beam engine's default options decode at its beam
        width."""
        if options is None and getattr(self, "beam_size", None):
            from ..pipeline.transcribe import TranscribeOptions

            options = TranscribeOptions(beam_size=self.beam_size)
        audio = np.zeros(max(1, int(16000 * seconds)), np.int16)
        ks = sorted({b for b in self._ADMIT_BUCKETS if b <= self.n_slots} | {self.n_slots})
        for k in ks:
            self.transcribe_streams([audio] * k, options)
        return self

    def _advance_stream(self, s: int, st: dict, pulled, topts, temps) -> bool:
        """Consume slot ``s``'s finished window into stream ``st``: the
        fallback gate and ladder, then finish_window's segments, seek and
        prompt carry. Returns True when the stream has no more windows."""
        from ..pipeline.transcribe import finish_window, gate_needs_fallback

        result = self._stream_result(s, pulled)
        self.stats["windows"] += 1
        if gate_needs_fallback(result, topts):
            with self.spans.stage("engine.fallback", "fallback_s", ids=(st["idx"],)):
                result = self._fallback_ladder(st, result, topts, temps)
            self.stats["fallbacks"] += 1
        enc_arg = self._slot_enc(s) if topts.word_timestamps else None
        segments, new_seek, new_tokens, reset = finish_window(
            self.model, result, st["seek"], st["content_frames"], self._n_frames, topts,
            len(st["segments"]), st["language"], enc=enc_arg)
        st["segments"].extend(segments)
        st["all_tokens"].extend(new_tokens)
        if reset:
            st["prompt_reset_since"] = len(st["all_tokens"])
        st["seek"] = new_seek
        return st["seek"] >= st["content_frames"]

    @staticmethod
    def _stream_output(st: dict) -> dict:
        segs = st["segments"]
        return {"text": "".join(seg.text for seg in segs),
                "segments": [dataclasses.asdict(seg) for seg in segs],
                "language": st["language"], "duration": st["duration"]}

    def _prepare_streams(self, topts) -> list:
        """Validate stream options, size the slot pool for wrapped prompts,
        and align the rule masks and timestamp cap with ``topts``. Returns
        the temperature ladder."""
        temps = ([topts.temperature] if isinstance(topts.temperature, (int, float))
                 else list(topts.temperature))
        if temps[0] != 0:
            raise ValueError("engine streams require a t=0 first ladder rung")
        # The pool must fit the longest wrapped prompt; it can grow only
        # before it exists.
        no_prompt = len(self.initial_tokens)
        p_max = self.cfg.n_text_ctx // 2 + no_prompt + 2
        w_max = -(-p_max // 32) * 32
        needed = min(w_max + self.max_new + 8, self.cfg.n_text_ctx)
        if needed > self.pool_ctx:
            if self._state is not None:
                raise RuntimeError("engine pool already sized without prompt budget; use a "
                                   "fresh SlotEngine for transcribe_streams")
            self._check_hbm_budget(pool_ctx=needed)
            self.pool_ctx = needed
        self._set_rules(*build_masks(self.vocab, self.device,
                                     suppress_tokens=topts.suppress_tokens),
                        None if topts.without_timestamps else round(1.0 / 0.02))
        return temps

    def _set_rules(self, sup_mask, blank_mask, max_initial_index: Optional[int]) -> None:
        """The decode step's rule masks, copied into their buffers, and its
        timestamp cap."""
        self.sup_mask.copy_(sup_mask)
        self.blank_mask.copy_(blank_mask)
        self.max_initial_index = max_initial_index

    # -- long-form scheduler hooks --

    def _check_stream_options(self, topts) -> None:
        if topts.beam_size or (topts.best_of or 1) != 1:
            raise ValueError("SlotEngine streams are greedy-first; beam windows belong to "
                             "BeamSlotEngine.transcribe_streams (or pipeline.transcribe)")
        self._check_common_stream_options(topts)

    def _check_common_stream_options(self, topts) -> None:
        # The cross pools and mel windows are sized once, at construction.
        if topts.audio_ctx is not None and topts.audio_ctx != self.audio_ctx:
            raise ValueError(
                f"engine streams decode at the engine's construction-time audio_ctx "
                f"({self.audio_ctx or 'full'}); per-call audio_ctx={topts.audio_ctx!r} cannot "
                f"be honored: build the engine with audio_ctx={topts.audio_ctx!r} or use "
                f"pipeline.transcribe (audio_ctx='auto' per-window bucketing)")

    def _stream_chunk_snapshot(self, topts) -> _HostCopy:
        """Run one decode chunk, count its steps (``decode_steps``) and start
        the copy of the harvest arrays (read one round later)."""
        use_ts = not topts.without_timestamps
        body = functools.partial(_decode_step, self.model.decoder, self._state,
                                 self._cross_pool_k, self._cross_pool_v, self.sup_mask,
                                 self.blank_mask, use_ts, self.max_initial_index)
        if self._home is None:
            self.spans.count("decode_steps", _decode_chunk(body, self._state, self.chunk_steps))
        else:
            captures = self._captures
            ran = _decode_chunk(functools.partial(self._graph_step, body,
                                                  (use_ts, self.max_initial_index)),
                                self._state, self.chunk_steps)
            # a capture follows one eager step; every other step is a replay
            new = self._captures - captures
            self.spans.count_together(decode_steps=ran, graph_steps=ran - new,
                                      graph_captures=new)
        return _snapshot(self._state)

    @functools.cached_property
    def _home(self) -> Optional[_GraphHome]:
        """Where this engine's step graphs are made; None off CUDA."""
        return _graph_home(self.device)

    def _graph_step(self, body: Callable[[], None], key: tuple) -> None:
        """One decode step as the replay of its CUDA graph for ``key`` (the
        rule options, Python branches of the body) over the current pools.
        The first step of a key on a pool runs ``body`` eagerly, then
        captures it. The kernels' launch counters count what the card runs:
        the capture's counts are taken back, and each replay adds them."""
        pools = (self._state, self._cross_pool_k, self._cross_pool_v)
        entry = self._step_graphs.get(key)
        if entry is not None and all(a is b for a, b in zip(entry[0], pools)):
            _, graph, launches = entry
            graph.replay()
            add_launches(launches)
            return
        self._home.warm_up(body)
        before = kernel_launches()
        graph = self._home.capture(body)
        launches = {k: n - before[k] for k, n in kernel_launches().items() if n != before[k]}
        add_launches({k: -n for k, n in launches.items()})
        self._step_graphs[key] = (pools, graph, launches)
        self._captures += 1

    def _stream_result(self, s: int, pulled) -> DecodingResult:
        """Slot ``s``'s window result, built as the offline t=0 rung builds it."""
        active, length, sum_lp, toks, nosp = pulled
        return self._harvest(s, toks, length, sum_lp, nosp)

    def _slot_enc(self, s: int):
        """The slot's resident encoder memory as a batch-1 ``enc`` for
        finish_window's word timing (the rows the window decoded against).
        An int8 pool's rows are dequantized for it: the alignment signal is
        then a within-tolerance approximation of the float one."""
        def rows(pool):
            if isinstance(pool, QuantKV):
                return (pool.data[:, s: s + 1].float()
                        * pool.scale[:, s: s + 1, :, None, :]).to(self.model.dtype)
            return pool[:, s: s + 1]

        return SimpleNamespace(cross_k=rows(self._cross_pool_k), cross_v=rows(self._cross_pool_v))

    @torch.inference_mode()
    def _init_stream(self, idx: int, audio, topts) -> dict:
        """Host and device state of one long-form stream: the whole padded
        mel on the device (windows are sliced from it per admission), the
        offline loop's content-frame accounting, and the prompt carry. The
        audio is padded to a multiple of 30 s; the extra zeros cannot move
        the mel's global max, so its prefix is the offline pipeline's."""
        audio = np.asarray(audio)
        if audio.dtype != np.int16:
            audio = audio.astype(np.float32)
        center = topts.mel_mode == "openai"
        offline_len = len(audio) + N_SAMPLES_PER_CHUNK
        padded_len = -(-offline_len // N_SAMPLES_PER_CHUNK) * N_SAMPLES_PER_CHUNK
        padded = np.zeros(padded_len, audio.dtype)
        padded[: len(audio)] = audio
        dev = _to_device(padded, self.device)  # int16 ships 2 bytes a sample
        if dev.dtype == torch.int16:
            dev = dev.float() / 32768.0
        mel = log_mel_spectrogram(dev, self.model.filters, frame_count(padded_len, center=center),
                                  center=center, fold=not center)
        content_frames = (frame_count(offline_len, center=center)
                          - N_SAMPLES_PER_CHUNK // HOP_LENGTH)
        seek_start = max(0, topts.offset_ms // 10)
        if topts.duration_ms is not None:
            content_frames = min(content_frames, seek_start + topts.duration_ms // 10)

        language = topts.language
        if language is None:
            if not self.cfg.is_multilingual:
                language = "en"
            else:
                with self.spans.stage("engine.detect_language", None, ids=(idx,)):
                    enc = self.model.encoder(mel_window(mel, seek_start, self._n_frames)[None])
                    langs, _ = detect_language(self.model.decoder, self.vocab, enc.cross_k,
                                               enc.cross_v)
                language = langs[0]

        all_tokens: List[int] = []
        if topts.initial_prompt is not None:
            from ..pipeline.transcribe import _tokenize_prompt

            all_tokens.extend(_tokenize_prompt(self.vocab, topts.initial_prompt))
        return {"idx": idx, "mel": mel, "content_frames": content_frames,
                "language": language, "seek": seek_start, "all_tokens": all_tokens,
                "prompt_reset_since": 0, "segments": [], "done": content_frames <= seek_start,
                "duration": len(audio) / 16000.0,
                # per-stream options survive into every later window
                "topts": topts}

    def _window_options(self, st: dict, topts, temperature: float) -> DecodingOptions:
        """The DecodingOptions the offline ladder would use for this window
        at this temperature."""
        topts = st.get("topts") or topts
        prompt = (st["all_tokens"][st["prompt_reset_since"]:]
                  if topts.condition_on_previous_text else [])
        kwargs = dict(task=topts.task, language=st["language"], temperature=temperature,
                      length_penalty=topts.length_penalty, prompt=prompt or None,
                      without_timestamps=topts.without_timestamps,
                      suppress_tokens=topts.suppress_tokens)
        # patience rides with beam_size only (openai drops both at t > 0)
        if temperature > 0:
            kwargs["best_of"] = topts.best_of
        else:
            kwargs["beam_size"] = topts.beam_size
            kwargs["patience"] = topts.patience
        return DecodingOptions(**kwargs)

    @torch.inference_mode()
    def _admit_stream_windows(self, join, topts) -> None:
        """Admit (slot, stream) pairs bucket by bucket, each bucket a stage
        (``engine.admit.bucket``) with its requests' ids."""
        i = 0
        while i < len(join):
            bucket = self._bucket_for(len(join) - i)
            group = join[i: i + bucket]
            with self._bucket_stage([st["idx"] for _, st in group], bucket):
                self._admit_stream_bucket(group, bucket, topts)
            i += len(group)

    def _admit_stream_bucket(self, group, bucket: int, topts) -> None:
        """Slice each stream's current window from its mel, encode and
        prefill the bucket with per-row prompts, and install. Per-row
        budgets follow the offline clamp sample_len <= n_text_ctx - prompt
        + 1."""
        dev = self.device
        n = len(group)
        wins = torch.stack([mel_window(st["mel"], st["seek"], self._n_frames)
                            for _, st in group])
        if n < bucket:
            wins = torch.cat([wins, wins.new_zeros((bucket - n,) + wins.shape[1:])])
        rows, lens, sots, caps = [], [], [], []
        for _, st in group:
            task = DecodingTask(self.cfg, self.vocab, self._window_options(st, topts, 0.0))
            toks = np.array(task.initial_tokens, np.int64)
            rows.append(toks)
            lens.append(len(toks))
            sots.append(task.sot_index)
            caps.append(max(0, min(task.sample_len, self.max_new,
                                   self.cfg.n_text_ctx - len(toks) + 1)))
        w = -(-max(len(r) for r in rows) // 32) * 32
        mat = np.zeros((bucket, w), np.int64)
        for j, r in enumerate(rows):
            mat[j, : len(r)] = r

        def col(values, pad):
            return _to_device(np.array(values + [pad] * (bucket - n), np.int64), dev)

        self._install_bucket([s for s, _ in group], wins, bucket,
                             tokens=_to_device(mat, dev), lengths=col(lens, 1),
                             sot_idx=col(sots, 0), max_news=col(caps, 0))

    @torch.inference_mode()
    def _fallback_ladder(self, st: dict, t0_result: DecodingResult, topts,
                         temps) -> DecodingResult:
        """Escalate a gated window through the remaining ladder rungs with
        ``decode_full``, as the offline ladder continues after its failed
        t=0 rung (routed as pipeline.transcribe routes its rungs: the
        device loop on the card, the host loop on the CPU, unless
        ``use_device_loop`` says otherwise)."""
        from ..pipeline.transcribe import gate_needs_fallback

        use_device = topts.use_device_loop
        if use_device is None:
            use_device = self.device.type == "cuda"
        enc = self.model.encoder(mel_window(st["mel"], st["seek"], self._n_frames)[None])
        result = t0_result
        for t in temps[1:]:
            result = decode_full(self.model.decoder, self.vocab, enc.cross_k, enc.cross_v,
                                 self._window_options(st, topts, t),
                                 use_device_loop=use_device)[0]
            if not gate_needs_fallback(result, topts):
                break
        return result
