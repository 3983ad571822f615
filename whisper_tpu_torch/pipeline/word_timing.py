"""Word-level timestamps via cross-attention DTW (openai's timing method).

Port of ``whisper_tpu/pipeline/word_timing.py``: teacher-force the segment's
tokens once, read the decoder's cross-attention distributions
(``model.decoder.cross_attention_probs``), z-normalize and median-filter the
alignment heads' average, dynamic-time-warp the (token, audio-frame) cost
matrix, and read word boundaries off the monotone path. The host helpers
(``median_filter``, ``dtw``, the alignment-head masks and
``split_tokens_on_spaces``) are copies of the originals, numpy only.

Alignment heads: the published per-release head sets
(``config.ALIGNMENT_HEADS``), selected from the GGML header
(``model_alignment_heads``); unknown models, and large-v1/v2, whose headers
are identical, use openai's fallback: every head of the upper half of the
decoder layers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

AUDIO_TIME_PER_TOKEN = 0.02  # seconds per (2x-downsampled) audio position


@dataclasses.dataclass
class WordTiming:
    word: str
    tokens: List[int]
    start: float
    end: float
    probability: float = 0.0


def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along the last axis with edge reflection (odd width)."""
    if width <= 1:
        return x
    pad = width // 2
    if x.shape[-1] <= pad:
        return x
    xp = np.concatenate(
        [x[..., 1 : pad + 1][..., ::-1], x, x[..., -pad - 1 : -1][..., ::-1]],
        axis=-1,
    )
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Dynamic time warping over an (N_tokens, M_frames) cost matrix.

    Returns (text_indices, time_indices) of the minimum-cost monotone path
    (openai's dtw_cpu semantics: moves are down, right, diagonal; strict-<
    tie-breaks exactly as whisper/timing.py's scalar loop). Vectorized over
    anti-diagonals: cell (i, j) depends only on diagonals d-1 and d-2, so
    each of the N+M-1 diagonals is one numpy vector step — ~100x fewer
    Python iterations than the naive O(N*M) scalar loop on a 30 s segment
    (~100 x 1500), which cost 0.1-0.3 s host time per segment."""
    N, M = cost.shape
    D = np.full((N + 1, M + 1), np.inf, dtype=np.float64)
    D[0, 0] = 0.0
    trace = np.zeros((N + 1, M + 1), dtype=np.int8)
    for d in range(2, N + M + 1):
        lo, hi = max(1, d - M), min(N, d - 1)
        if lo > hi:
            continue
        i = np.arange(lo, hi + 1)
        j = d - i
        c0 = D[i - 1, j - 1]
        c1 = D[i - 1, j]
        c2 = D[i, j - 1]
        t = np.where((c0 < c1) & (c0 < c2), 0, np.where(c1 < c2, 1, 2))
        val = np.where(t == 0, c0, np.where(t == 1, c1, c2))
        D[i, j] = val + cost[i - 1, j - 1]
        trace[i, j] = t
    i, j = N, M
    text_indices, time_indices = [], []
    while i > 0 or j > 0:
        text_indices.append(i - 1)
        time_indices.append(j - 1)
        if i > 0 and j > 0:
            t = trace[i, j]
        elif i > 0:
            t = 1
        else:
            t = 2
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(text_indices[::-1]), np.array(time_indices[::-1])


def default_alignment_heads(n_layer: int, n_head: int) -> np.ndarray:
    """(L, H) bool mask — openai's fallback: all heads of the upper half."""
    mask = np.zeros((n_layer, n_head), dtype=bool)
    mask[n_layer // 2 :] = True
    return mask


def model_alignment_heads(cfg, n_layer: int, n_head: int) -> np.ndarray:
    """(L, H) bool mask for the model ``cfg`` describes: the published
    per-release head set (config.ALIGNMENT_HEADS) when the GGML header
    resolves a released model unambiguously, else the upper-half fallback
    (unknown models, and large-v1/v2 whose headers are identical)."""
    from ..config import lookup_alignment_heads

    pairs = lookup_alignment_heads(cfg)
    if not pairs:
        return default_alignment_heads(n_layer, n_head)
    mask = np.zeros((n_layer, n_head), dtype=bool)
    for l, h in pairs:
        if l < n_layer and h < n_head:
            mask[l, h] = True
    if not mask.any():  # defensive: malformed table entry
        return default_alignment_heads(n_layer, n_head)
    return mask


def split_tokens_on_spaces(vocab, tokens: Sequence[int]):
    """Group tokens into words: a token whose text begins with a space (or
    follows punctuation rules) starts a new word (openai's spaced-language
    splitter, simplified to byte-level rules)."""
    words: List[str] = []
    word_tokens: List[List[int]] = []
    for tok in tokens:
        if tok >= vocab.token_eot:
            continue
        piece = vocab.token_bytes(int(tok)).decode("utf-8", errors="replace")
        special = tok >= vocab.token_eot
        with_space = piece.startswith(" ")
        punctuation = piece.strip() in "\"'“¿([{-\"'.。,，!！?？:：”)]}、"
        if not words or (with_space and not punctuation) or special:
            words.append(piece)
            word_tokens.append([int(tok)])
        else:
            words[-1] += piece
            word_tokens[-1].append(int(tok))
    return words, word_tokens


def find_word_timestamps(
    decoder,
    vocab,
    cross_k,
    cross_v,
    text_tokens: Sequence[int],
    initial_tokens: Sequence[int],
    *,
    num_frames: Optional[int] = None,
    time_offset: float = 0.0,
    alignment_heads: Optional[np.ndarray] = None,
    medfilt_width: int = 7,
) -> List[WordTiming]:
    """Word boundary times for one decoded window, over the model's
    ``TextDecoder``.

    cross_k/cross_v: the window's encoder memory (batch 1, float).
    text_tokens: the sampled tokens (timestamp tokens are filtered).
    num_frames: valid audio positions (content frames / 2); attention beyond
    it is ignored.
    """
    import torch

    from ..model.decoder import cross_attention_probs

    eot = vocab.token_eot
    # openai filters timestamp/special tokens before the alignment pass; the
    # trailing EOT row of the matrix supplies the final word's end boundary.
    text_tokens = [int(t) for t in text_tokens if int(t) < eot]
    if not text_tokens:
        return []
    cfg = decoder.cfg
    sequence = list(initial_tokens) + text_tokens + [eot]
    device = getattr(cross_k, "data", cross_k).device
    tokens = torch.tensor([sequence], dtype=torch.long, device=device)
    # (L, 1, H, T, Ta) on the device: select the alignment heads and slice
    # the valid frames there, and fetch only (N_heads, T, nf)
    probs = cross_attention_probs(decoder, tokens, cross_k, cross_v)
    L, _, H, T, Ta = probs.shape
    if alignment_heads is None:
        alignment_heads = model_alignment_heads(cfg, L, H)
    idx_l, idx_h = np.nonzero(alignment_heads)
    w = probs[torch.from_numpy(idx_l).to(device), 0, torch.from_numpy(idx_h).to(device)]
    nf = Ta if num_frames is None else max(1, min(num_frames, Ta))
    w = w[..., :nf]
    # openai slices to num_frames BEFORE the softmax (whisper/timing.py);
    # a softmax restricted to the slice is the full softmax renormalized
    # over it, exactly, so renormalize rather than re-running attention.
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-10)
    w = w.float().cpu().numpy()
    # openai order: z-normalize over the token axis, THEN median-filter
    # (the two don't commute).
    std = w.std(axis=-2, keepdims=True)
    mean = w.mean(axis=-2, keepdims=True)
    w = (w - mean) / np.maximum(std, 1e-8)
    w = median_filter(w, medfilt_width)
    matrix = w.mean(axis=0)                         # (T, nf)
    # align only the sampled region (skip sot/prompt prefix, keep final EOT)
    begin = len(initial_tokens)
    matrix = matrix[begin:]
    text_indices, time_indices = dtw(-matrix.astype(np.float64))

    words, word_tokens = split_tokens_on_spaces(vocab, text_tokens)
    if not words:
        return []
    # token boundary time = first path position where the token index jumps
    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    jump_times = time_indices[jumps] * AUDIO_TIME_PER_TOKEN
    n_aligned = matrix.shape[0]
    token_starts = np.zeros(n_aligned)
    token_starts[: len(jump_times)] = jump_times[:n_aligned]
    # boundaries per word from cumulative token counts
    out: List[WordTiming] = []
    idx = 0
    for word, toks in zip(words, word_tokens):
        start_idx = idx
        idx += len(toks)
        if start_idx >= n_aligned:
            break
        start = float(token_starts[start_idx])
        end = float(token_starts[idx]) if idx < n_aligned else float(
            (time_indices[-1] + 1) * AUDIO_TIME_PER_TOKEN
        )
        if word.strip():
            out.append(
                WordTiming(
                    word=word, tokens=toks,
                    start=round(time_offset + start, 2),
                    end=round(time_offset + max(end, start), 2),
                )
            )
    return out
