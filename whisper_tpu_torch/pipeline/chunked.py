"""Chunk-parallel long-form transcription.

Port of ``whisper_tpu/pipeline/chunked.py`` on one device. With
previous-text conditioning off, every 30 s window is independent work: the
audio is cut into fixed windows, up to ``batch_windows`` of them are encoded
as one batch (K1 in every encoder layer at batch·heads rows) and decoded in
lockstep by the device loop (K5 in every decoder layer at every step, at
batch = the windows of the group).

With ``overlap_seconds > 0`` windows overlap and the merge keeps each
segment from the window that sees it furthest from its edges (cut at the
overlap midpoint): a word clipped by one window's edge lies whole inside its
neighbour. ``overlap_seconds=0`` keeps disjoint windows; the sequential
``pipeline.transcribe`` stays the accuracy-first path. A device mesh is not
ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from ..config import HOP_LENGTH, N_SAMPLES_PER_CHUNK, SAMPLE_RATE
from ..decoding.result import Segment
from ..decoding.task import DecodingOptions, decode_full, detect_language
from ..frontend.mel import frame_count, log_mel_spectrogram, mel_window
from ..model.load import WhisperModel
from .transcribe import N_FRAMES, TranscribeOptions, _sync

_MAX_BATCH = 16  # windows per device batch (the JAX package's memory bound for large-v3)


@torch.inference_mode()
def transcribe_chunked(
    model: WhisperModel,
    audio: Union[str, np.ndarray],
    options: Optional[TranscribeOptions] = None,
    mesh=None,
    batch_windows: int = _MAX_BATCH,
    overlap_seconds: float = 0.0,
    **kwargs,
) -> dict:
    """Fixed-stride chunk-parallel transcription (no prompt conditioning) on
    the model's device -> {text, segments, language, duration}. Stage wall
    times (mel, encode, decode; each ending in a device synchronise) go to
    ``model.timers``.

    overlap_seconds > 0 overlaps adjacent windows and merges their segments
    at the overlap midpoints (~overlap/30 extra compute)."""
    if mesh is not None:
        raise NotImplementedError("chunked transcription over a device mesh needs the port's "
                                  "tensor parallelism, which is not ported yet")
    opts = options or TranscribeOptions(**kwargs)
    cfg, vocab = model.config, model.vocab

    if isinstance(audio, str):
        from ..io.wav import load_wav

        audio = load_wav(audio)
    audio = np.asarray(audio, dtype=np.float32)

    with model.timers.stage("mel"):
        padded = np.pad(audio, (0, N_SAMPLES_PER_CHUNK))
        center = opts.mel_mode == "openai"
        mel = log_mel_spectrogram(
            torch.from_numpy(padded).to(model.device), model.filters,
            frame_count(len(padded), center), center=center, fold=not center,
        )
        _sync(model.device)
    content_frames = mel.shape[-1] - N_FRAMES
    # clip range (whisper.cpp offset_ms/duration_ms; 10 ms frames)
    seek_start = max(0, opts.offset_ms // 10)
    if opts.duration_ms is not None:
        content_frames = min(content_frames, seek_start + opts.duration_ms // 10)
    overlap_frames = int(overlap_seconds * SAMPLE_RATE / HOP_LENGTH)
    overlap_frames = max(0, min(overlap_frames, N_FRAMES - 100))
    stride = N_FRAMES - overlap_frames
    if seek_start and seek_start >= content_frames:
        offsets = []  # clip starts past the audio: nothing to decode
    else:
        # seek_start=0 keeps the one-window floor for short clips
        offsets = list(range(seek_start, max(content_frames, seek_start + 1), stride))

    language = opts.language or ("en" if not cfg.is_multilingual else None)
    window_results: List[tuple] = []  # (offset_frames, [Segment])
    for group_start in range(0, len(offsets), batch_windows):
        group = offsets[group_start: group_start + batch_windows]
        windows = torch.stack([mel_window(mel, off, N_FRAMES) for off in group])
        with model.timers.stage("encode"):
            enc = model.encoder(windows)
            _sync(model.device)

        if language is None:
            langs, _ = detect_language(model.decoder, vocab, enc.cross_k, enc.cross_v)
            language = langs[0]

        dec_opts = DecodingOptions(
            task=opts.task,
            language=language,
            temperature=0.0,
            without_timestamps=opts.without_timestamps,
            suppress_tokens=opts.suppress_tokens,
        )
        with model.timers.stage("decode"):
            results = decode_full(model.decoder, vocab, enc.cross_k, enc.cross_v, dec_opts,
                                  use_device_loop=True)

        for idx, off in enumerate(group):
            result = results[idx]
            if (
                opts.no_speech_threshold is not None
                and result.no_speech_prob > opts.no_speech_threshold
                and (
                    opts.logprob_threshold is None
                    or result.avg_logprob < opts.logprob_threshold
                )
            ):
                window_results.append((off, []))
                continue
            time_offset = off * HOP_LENGTH / SAMPLE_RATE
            window_frames = min(N_FRAMES, content_frames - off)
            window_results.append((off, extract_segments(
                result, vocab, time_offset, window_frames * HOP_LENGTH / SAMPLE_RATE,
                seek=off,
            )))

    all_segments = merge_window_segments(window_results, overlap_frames)
    return {
        "text": "".join(seg.text for seg in all_segments),
        "segments": [dataclasses.asdict(s) for s in all_segments],
        "language": language or "en",
        "duration": len(audio) / SAMPLE_RATE,
    }


def merge_window_segments(window_results: List[tuple], overlap_frames: int) -> List[Segment]:
    """Merge per-window segment lists from (possibly overlapping) windows.

    Each segment is kept by exactly one window, the one whose keep-range
    [own_start + overlap/2, next_start + overlap/2) contains the segment's
    midpoint, so boundary-clipped fragments from a window edge are replaced
    by the neighbour's full-view version. Disjoint windows (overlap 0)
    reduce to plain concatenation.
    """
    spf = HOP_LENGTH / SAMPLE_RATE  # seconds per mel frame
    half = overlap_frames * spf / 2.0
    out: List[Segment] = []
    for i, (off, segments) in enumerate(window_results):
        lo = -np.inf if i == 0 else off * spf + half
        hi = window_results[i + 1][0] * spf + half if i + 1 < len(window_results) else np.inf
        for seg in segments:
            mid = (seg.t0 + seg.t1) / 2.0
            if lo <= mid < hi:
                out.append(dataclasses.replace(seg, id=len(out)))
    return out


def extract_segments(result, vocab, time_offset: float, window_duration: float,
                     seek: int, base_id: int = 0) -> List[Segment]:
    """Split one window's tokens into timestamp-delimited segments (the
    grammar of the sequential pipeline's ``finish_window``)."""
    tokens = np.array(result.tokens)
    segments: List[Segment] = []

    def mk(start, end, seg_tokens):
        # clamp into the window (degenerate timestamps can point past it)
        hi = time_offset + window_duration
        start = min(max(start, time_offset), hi)
        end = min(max(end, start), hi)
        text_tokens = [int(t) for t in seg_tokens if t < vocab.token_eot]
        segments.append(
            Segment(
                id=base_id + len(segments),
                seek=seek,
                t0=float(start),
                t1=float(end),
                text=vocab.decode(text_tokens),
                tokens=[int(t) for t in seg_tokens],
                avg_logprob=result.avg_logprob,
                no_speech_prob=result.no_speech_prob,
                temperature=result.temperature,
                compression_ratio=result.compression_ratio,
            )
        )

    if len(tokens) == 0:
        return segments
    ts_mask = tokens >= vocab.token_beg
    consecutive = np.where(ts_mask[:-1] & ts_mask[1:])[0] + 1
    if len(consecutive) > 0:
        last = 0
        for cur in consecutive.tolist():
            sliced = tokens[last:cur]
            mk(
                time_offset + (sliced[0].item() - vocab.token_beg) * 0.02,
                time_offset + (sliced[-1].item() - vocab.token_beg) * 0.02,
                sliced.tolist(),
            )
            last = cur
        tail = tokens[last:]
        if len(tail) > 1:
            t0_tail = (time_offset + (tail[0].item() - vocab.token_beg) * 0.02
                       if tail[0] >= vocab.token_beg else time_offset)
            if not ts_mask[-2] and ts_mask[-1]:
                # a trailing single timestamp closes the last segment at that
                # timestamp, as the sequential grammar does
                mk(t0_tail, time_offset + (tail[-1].item() - vocab.token_beg) * 0.02,
                   tail.tolist())
            else:
                # unterminated tail: the sequential loop would re-decode it in
                # the next window; chunked windows are independent, so emit it
                # bounded by the window end
                mk(t0_tail, time_offset + window_duration, tail.tolist())
    else:
        duration = window_duration
        timestamps = tokens[ts_mask]
        if len(timestamps) > 0 and timestamps[-1].item() != vocab.token_beg:
            duration = (timestamps[-1].item() - vocab.token_beg) * 0.02
        mk(time_offset, time_offset + duration, tokens.tolist())
    return segments
