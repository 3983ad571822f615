"""DecodingTask: one pass of the decoder over encoded audio windows.

Port of ``whisper_tpu/decoding/task.py``: ``DecodingOptions``, the 32-token
prefill bucket, openai's initial-token construction, the host-orchestrated
loop (``DecodingTask.run``: logit filters, greedy, best_of or beam
bookkeeping and the ranker on host numpy, one device forward per token, the
beam cache reordered by the row-gather kernel K6; with ``use_topk_device``
the beam's rules and top-k run on the device, ``decoding.topk_step``),
``decode_full``'s routing to the device loops (greedy,
``decoding.device_loop``; beam, ``decoding.device_beam``) and
``detect_language``. Beam and best_of rows share their group's cross memory:
the decoder folds the group axis into the query when the cross batch is
smaller.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import WhisperConfig
from ..io.vocab import WhisperVocab
from ..kernels.beam_gather import permute_cache_rows
from ..model.decoder import TextDecoder, decode_step, init_cache
from .result import DecodingResult, compression_ratio
from .rules import (ApplyTimestampRules, SuppressBlank, SuppressTokens, build_suppress_list,
                    log_softmax)
from .sequence import BeamSearchDecoder, GreedyDecoder, MaximumLikelihoodRanker


@dataclasses.dataclass(frozen=True)
class DecodingOptions:
    task: str = "transcribe"           # "transcribe" | "translate"
    language: Optional[str] = None     # None -> "en" (transcribe detects it first)
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
    """openai's ``DecodingTask``: option checks, token layout, logit
    filters, the sequence decoder (greedy or beam) and the ranker, and the
    host loop ``run`` over ``text_decoder`` (the model's ``TextDecoder``)."""

    def __init__(self, config: WhisperConfig, vocab: WhisperVocab, options: DecodingOptions,
                 text_decoder: Optional[TextDecoder] = None):
        self.config = config
        self.vocab = vocab
        self.options = options
        self.text_decoder = text_decoder  # used by run()
        # option-compatibility contract (openai decoding.py _verify_options)
        if options.beam_size is not None and options.best_of is not None:
            raise ValueError("beam_size and best_of can't be given together")
        if options.beam_size is not None and options.temperature > 0:
            raise ValueError("beam search is only valid at temperature 0")
        if options.temperature == 0 and options.best_of is not None:
            raise ValueError("best_of with greedy sampling is not compatible")
        if options.patience is not None and options.beam_size is None:
            raise ValueError("patience requires beam_size to be given")
        self.n_group = options.beam_size or options.best_of or 1
        self.sample_len = options.sample_len or config.n_text_ctx // 2
        self.sot_sequence = self._sot_sequence()
        self.initial_tokens = self._initial_tokens()
        self.sample_begin = len(self.initial_tokens)
        self.sot_index = self.initial_tokens.index(vocab.token_sot)

        if options.beam_size is not None:
            self.decoder = BeamSearchDecoder(options.beam_size, vocab.token_eot, options.patience)
        else:
            self.decoder = GreedyDecoder(options.temperature, vocab.token_eot, options.seed)
        self.ranker = MaximumLikelihoodRanker(options.length_penalty)

        self.filters = []
        if options.suppress_blank:
            self.filters.append(SuppressBlank(vocab, self.sample_begin))
        if options.suppress_tokens:
            self.filters.append(SuppressTokens(build_suppress_list(vocab, options.suppress_tokens)))
        if not options.without_timestamps:
            max_initial_index = None
            if options.max_initial_timestamp is not None:
                max_initial_index = round(options.max_initial_timestamp / 0.02)
            self.filters.append(ApplyTimestampRules(vocab, self.sample_begin, max_initial_index))

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

    def run(self, cross_k, cross_v, use_topk_device: bool = False) -> List[DecodingResult]:
        """Decode the windows of the cross memory (L, n_audio, H, D, Ta),
        float or ``QuantKV``, one result per window. Rows are
        group-contiguous (n_audio * n_group of them: beams, or best_of
        samples) and share their window's cross memory.

        ``use_topk_device``: for beam search, apply the logit rules on the
        device and fetch only the top beam_size + 1 candidates a step (the
        same candidate set as the host filters give; no full-vocab logits
        fetch). Any other decoder ignores it, as JAX's does."""
        if self.text_decoder is None:
            raise ValueError("DecodingTask.run needs the model's TextDecoder")
        cfg, v = self.config, self.vocab
        n_audio = _cross_batch(cross_k)
        n_seq = n_audio * self.n_group
        device = getattr(cross_k, "data", cross_k).device
        beam = isinstance(self.decoder, BeamSearchDecoder)
        use_topk = use_topk_device and beam
        if use_topk:
            from .topk_step import decode_step_topk, rule_state_from_tokens

            sup_mask, blank_mask, max_initial_index = _rule_masks(v, self.options, device)

        self.decoder.reset()
        tokens = np.tile(np.array(self.initial_tokens, np.int64), (n_seq, 1))
        cache = init_cache(cfg, n_seq, _cache_dtype(cross_k), device)

        # Prefill (bucketed), one forward for the whole prompt. Only two
        # positions of the (n_seq, P, V) logits are read (SOT for the
        # no-speech probability, true_len - 1 to seed sampling): slice them
        # on the device before the fetch.
        padded, true_len = _pad_to_bucket(tokens)
        logits_all, cache = decode_step(self.text_decoder, torch.from_numpy(padded).to(device),
                                        0, cache, cross_k, cross_v)
        two = logits_all[:, [self.sot_index, true_len - 1]].float().cpu().numpy()
        no_speech_probs = np.exp(log_softmax(two[:, 0]))[:, v.token_nosp]
        logits = two[:, 1]
        n_past = true_len

        sum_logprobs = np.zeros(n_seq, dtype=np.float64)
        topk = None  # (top log-probabilities, ids) once the device applies the rules
        for _ in range(self.sample_len):
            if topk is not None:
                tokens, completed, sources = self.decoder.update_from_topk(
                    tokens, topk[0], topk[1], sum_logprobs)
            else:
                filt = logits.copy()
                for f in self.filters:
                    f(filt, tokens)
                tokens, completed, *sources = self.decoder.update(tokens, filt, sum_logprobs)
                sources = sources[0] if beam else None
            if beam and not np.array_equal(sources, np.arange(n_seq)):
                cache = permute_cache_rows(cache, torch.from_numpy(sources).to(device))
            if completed or tokens.shape[-1] > cfg.n_text_ctx:
                break
            next_tok = torch.from_numpy(tokens[:, -1:]).to(device)
            if use_topk:
                last_t, prev_t, last_ts, step = rule_state_from_tokens(
                    tokens, self.sample_begin, v.token_beg, device)
                top_lp, top_ids, _, cache = decode_step_topk(
                    self.text_decoder, next_tok, n_past, cache, cross_k, cross_v, sup_mask,
                    blank_mask, last_t, prev_t, last_ts, step, k=self.options.beam_size + 1,
                    use_timestamps=not self.options.without_timestamps,
                    max_initial_index=max_initial_index)
                topk = (top_lp.cpu().numpy(), top_ids.cpu().numpy())
            else:
                lg, cache = decode_step(self.text_decoder, next_tok, n_past, cache, cross_k,
                                        cross_v)
                logits = lg[:, 0].float().cpu().numpy()
            n_past += 1

        # Finalize and rank.
        final_tokens, final_logprobs = self.decoder.finalize(tokens, sum_logprobs)
        if beam:
            grouped_tokens = [[seq[self.sample_begin:_eot_index(seq, v.token_eot)]
                               for seq in group] for group in final_tokens]
            grouped_logprobs = final_logprobs
        else:
            grouped_tokens, grouped_logprobs = [], []
            for i in range(n_audio):
                rows = range(i * self.n_group, (i + 1) * self.n_group)
                seqs = [final_tokens[r].tolist() for r in rows]
                grouped_tokens.append([s[self.sample_begin:_eot_index(s, v.token_eot)]
                                       for s in seqs])
                grouped_logprobs.append([final_logprobs[r] for r in rows])

        selected = self.ranker.rank(grouped_tokens, grouped_logprobs)
        results = []
        for i, j in enumerate(selected):
            toks = [int(t) for t in grouped_tokens[i][j]]
            text = v.decode(toks).strip()
            results.append(DecodingResult(
                tokens=toks, text=text,
                avg_logprob=float(grouped_logprobs[i][j] / (len(toks) + 1)),
                no_speech_prob=float(no_speech_probs[i * self.n_group]),
                temperature=self.options.temperature,
                compression_ratio=compression_ratio(text),
            ))
        return results


def _eot_index(seq: List[int], eot: int) -> int:
    return seq.index(eot) if eot in seq else len(seq)


def decode_full(decoder: TextDecoder, vocab: WhisperVocab, cross_k, cross_v,
                options: DecodingOptions, use_device_loop: bool = False) -> List[DecodingResult]:
    """Decode encoded windows (cross memory (L, B, H, D, Ta), float or
    ``QuantKV``) with ``options``, one result per window.

    ``use_device_loop`` routes greedy/temperature decoding through the device
    loop (``decoding.device_loop``) and beam search without ``patience``
    through the device beam (``decoding.device_beam``); beam search with
    ``patience`` takes the host loop with the device top-k step, and best_of
    groups the host loop, as JAX's ``decode_full`` routes them."""
    if use_device_loop and options.beam_size is None and (options.best_of or 1) == 1:
        return _decode_full_device(decoder, vocab, cross_k, cross_v, options)
    if use_device_loop and options.beam_size is not None and options.patience is None:
        return _decode_full_device_beam(decoder, vocab, cross_k, cross_v, options)
    task = DecodingTask(decoder.cfg, vocab, options, decoder)
    return task.run(cross_k, cross_v, use_topk_device=use_device_loop)


def _rule_masks(vocab: WhisperVocab, options: DecodingOptions, device: torch.device | str):
    """The device rules' suppress and blank masks on ``device`` and the
    first timestamp's cap (None without timestamps)."""
    from .device_loop import build_masks

    sup_mask, blank_mask = build_masks(vocab, device, suppress_tokens=options.suppress_tokens)
    if not options.suppress_blank:
        blank_mask = torch.zeros_like(blank_mask)
    max_initial_index = None
    if options.max_initial_timestamp is not None and not options.without_timestamps:
        max_initial_index = round(options.max_initial_timestamp / 0.02)
    return sup_mask, blank_mask, max_initial_index


def _device_decode_prologue(config: WhisperConfig, vocab: WhisperVocab,
                            options: DecodingOptions, n_rows: int,
                            device: torch.device | str):
    """Masks, tiled and bucketed prompt rows, timestamp cap, and openai's
    context budget: up to n_text_ctx - true_len + 1 tokens are sampled."""
    task = DecodingTask(config, vocab, options)
    sup_mask, blank_mask, max_initial_index = _rule_masks(vocab, options, device)
    init = np.tile(np.array(task.initial_tokens, np.int64), (n_rows, 1))
    padded, true_len = _pad_to_bucket(init)
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


def _decode_full_device_beam(decoder: TextDecoder, vocab: WhisperVocab, cross_k, cross_v,
                             options: DecodingOptions) -> List[DecodingResult]:
    """Beam search through ``device_beam.beam_decode_device``, with openai's
    finalize (pad with in-flight beams by score) and the ranker."""
    from .device_beam import beam_decode_device

    config = decoder.cfg
    k = options.beam_size
    n_audio = _cross_batch(cross_k)
    device = getattr(cross_k, "data", cross_k).device
    (task, padded, true_len, sup_mask, blank_mask, max_initial_index,
     sample_len) = _device_decode_prologue(config, vocab, options, n_audio * k, device)
    cache = init_cache(config, n_audio * k, dtype=_cache_dtype(cross_k), device=device,
                       ctx=padded.shape[1] + sample_len + 8)
    (act_toks, act_lp, fin_toks, fin_scores, fin_len, fin_count, steps,
     nosp) = beam_decode_device(
        decoder, torch.from_numpy(padded).to(device), true_len, task.sot_index, cache,
        cross_k, cross_v, sup_mask, blank_mask, beam_size=k, sample_len=sample_len,
        use_timestamps=not options.without_timestamps, max_initial_index=max_initial_index)
    act_toks, act_lp, fin_toks, fin_scores, fin_len, fin_count, nosp = (
        t.cpu().numpy() for t in (act_toks, act_lp, fin_toks, fin_scores, fin_len, fin_count,
                                  nosp))

    results = []
    for g in range(n_audio):
        seqs: List[List[int]] = []
        lps: List[float] = []
        for i in range(int(fin_count[g])):
            seqs.append([int(t) for t in fin_toks[g, i, :int(fin_len[g, i])]])
            lps.append(float(fin_scores[g, i]))
        if len(seqs) < k:
            # openai's finalize: pad with in-flight beams by score (+ EOT)
            for i in np.argsort(-act_lp[g]):
                if len(seqs) >= k:
                    break
                seqs.append([int(t) for t in act_toks[g, int(i), :steps]])
                lps.append(float(act_lp[g, int(i)]))
        sel = task.ranker.rank([seqs], [lps])[0]
        toks = seqs[sel]
        text = vocab.decode(toks).strip()
        results.append(DecodingResult(
            tokens=toks, text=text,
            avg_logprob=float(lps[sel] / (len(toks) + 1)),
            no_speech_prob=float(nosp[g]),
            temperature=options.temperature,
            compression_ratio=compression_ratio(text),
        ))
    return results


def detect_language(decoder: TextDecoder, vocab: WhisperVocab, cross_k,
                    cross_v) -> Tuple[List[str], List[dict]]:
    """One forward of SOT, the distribution over the language tokens only
    (openai's ``detect_language``): the languages and, per window, every
    language's probability."""
    n_audio = _cross_batch(cross_k)
    device = getattr(cross_k, "data", cross_k).device
    # one T = 1 forward writes one KV column: a throwaway cache of 8 positions
    cache = init_cache(decoder.cfg, n_audio, _cache_dtype(cross_k), device, ctx=8)
    tokens = torch.full((n_audio, 1), vocab.token_sot, dtype=torch.long, device=device)
    logits, _ = decode_step(decoder, tokens, 0, cache, cross_k, cross_v)
    logits = logits[:, 0].float().cpu().numpy()
    mask = np.full(logits.shape[-1], True)
    mask[vocab.all_language_tokens] = False
    logits[:, mask] = -np.inf
    probs = np.exp(log_softmax(logits))
    langs, all_probs = [], []
    for i in range(n_audio):
        langs.append(vocab.language_of_token(int(probs[i].argmax())))
        all_probs.append({lang: float(probs[i, vocab.language_token(lang)])
                          for lang in vocab.languages})
    return langs, all_probs
