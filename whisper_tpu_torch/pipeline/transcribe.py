"""Long-form transcription: the 30 s sliding-window loop with the
temperature fallback ladder (whisper_full).

Port of ``whisper_tpu/pipeline/transcribe.py``, with openai-whisper's
``transcribe()`` semantics: segments from timestamp tokens, seek
advancement, previous-text conditioning and its reset, the temperature
ladder with compression-ratio / avg-logprob gates, the no-speech skip,
language detection on the first window (its encoding reused by that
window's decode), ``offset_ms``/``duration_ms``, ``audio_ctx`` (an int, or
"auto" in 512-frame buckets), token-level and word-level timestamps.

The log-mel of the whole zero-padded file is computed once on the model's
device and windows are sliced from it (``mel_window`` zero-pads past the
end). Per window the device runs one encoder forward (K1 in every layer)
and the decode loop (K5 in every decoder layer at every forward; the device
beam adds K7, the host beam K6); the host keeps the bookkeeping.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import HOP_LENGTH, N_SAMPLES_PER_CHUNK, SAMPLE_RATE
from ..decoding.result import DecodingResult, Segment
from ..decoding.task import DecodingOptions, decode_full, detect_language
from ..frontend.mel import frame_count, log_mel_spectrogram, mel_window
from ..model.load import WhisperModel
from ..utils.logging import get_logger

log = get_logger("transcribe")

N_FRAMES = 3000  # 30 s of mel frames == 2 * n_audio_ctx
INPUT_STRIDE = 2  # mel frames per timestamp tick (0.02 s)


@dataclasses.dataclass
class TranscribeOptions:
    task: str = "transcribe"
    language: Optional[str] = None
    temperature: Union[float, Sequence[float]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    beam_size: Optional[int] = None
    best_of: Optional[int] = None
    patience: Optional[float] = None
    length_penalty: Optional[float] = None
    compression_ratio_threshold: Optional[float] = 2.4
    logprob_threshold: Optional[float] = -1.0
    no_speech_threshold: Optional[float] = 0.6
    condition_on_previous_text: bool = True
    initial_prompt: Optional[str] = None
    without_timestamps: bool = False
    token_timestamps: bool = False  # per-token t0/t1 (whisper.cpp algorithm)
    word_timestamps: bool = False   # word-level DTW (openai's timing method)
    # Encode only the first audio_ctx positions; "auto" derives it per
    # window from the remaining content frames, rounded up to 512-frame
    # buckets: full windows are unchanged, only a short last window stops
    # paying the 1500-position encode and cross reads.
    audio_ctx: Union[int, str, None] = None
    # Clip range (whisper.cpp's offset_ms/duration_ms): start the loop at
    # offset_ms and stop duration_ms later; segment times stay absolute.
    offset_ms: int = 0
    duration_ms: Optional[int] = None
    suppress_tokens: Optional[Sequence[int]] = (-1,)
    mel_mode: str = "openai"  # "openai" (center) | "reference" (whisper.cpp-1.0.3)
    # Kept for the JAX package's signature only: it has no effect here, the
    # port's encoder always runs the flash-attention kernel (K1).
    use_flash: bool = False
    # None: the device loop when the model is on a CUDA card, the host loop
    # on the CPU (beam search with patience and best_of take the host loop
    # either way, as decode_full routes them).
    use_device_loop: Optional[bool] = None
    verbose: bool = False


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _decode_with_fallback(
    model: WhisperModel, cross_k, cross_v, opts: TranscribeOptions, prompt: List[int],
) -> DecodingResult:
    temperatures = (
        [opts.temperature] if isinstance(opts.temperature, (int, float)) else list(opts.temperature)
    )
    use_device = opts.use_device_loop
    if use_device is None:
        use_device = model.device.type == "cuda"
    decode_result = None
    for t in temperatures:
        kwargs = dict(
            task=opts.task,
            language=opts.language,
            temperature=t,
            length_penalty=opts.length_penalty,
            prompt=prompt or None,
            without_timestamps=opts.without_timestamps,
            suppress_tokens=opts.suppress_tokens,
        )
        # openai's transcribe drops beam_size AND patience at t>0 (patience
        # without beam is a DecodingOptions contract violation)
        if t > 0:
            kwargs["best_of"] = opts.best_of
        else:
            kwargs["beam_size"] = opts.beam_size
            kwargs["patience"] = opts.patience
        # (The JAX package's speculative greedy rung needs a draft model,
        # which the port does not have yet: every rung decodes plainly.)
        decode_result = decode_full(model.decoder, model.vocab, cross_k, cross_v,
                                    DecodingOptions(**kwargs), use_device_loop=use_device)[0]
        if not gate_needs_fallback(decode_result, opts):
            break
    return decode_result


def gate_needs_fallback(result: DecodingResult, opts: TranscribeOptions) -> bool:
    """The temperature-ladder escalation gate (openai transcribe semantics)."""
    needs_fallback = False
    if (
        opts.compression_ratio_threshold is not None
        and result.compression_ratio > opts.compression_ratio_threshold
    ):
        needs_fallback = True  # too repetitive
    if (
        opts.logprob_threshold is not None
        and result.avg_logprob < opts.logprob_threshold
    ):
        needs_fallback = True  # average log probability too low
    if (
        opts.no_speech_threshold is not None
        and result.no_speech_prob > opts.no_speech_threshold
    ):
        needs_fallback = False  # silence: don't ladder, caller skips
    return needs_fallback


@torch.inference_mode()
def transcribe(
    model: WhisperModel,
    audio: Union[str, np.ndarray],
    options: Optional[TranscribeOptions] = None,
    **kwargs,
) -> dict:
    """Transcribe audio (a WAV path or 16 kHz f32 PCM) on the model's device
    -> {text, segments, language, duration}. Stage wall times (mel, lang_id,
    encode, decode, word_align; each ending in a device synchronise) go to
    ``model.timers``."""
    opts = options or TranscribeOptions(**kwargs)
    if options is not None and kwargs:
        opts = dataclasses.replace(options, **kwargs)
    cfg, vocab = model.config, model.vocab

    if isinstance(audio, str):
        from ..io.wav import load_wav

        audio = load_wav(audio)
    audio = np.asarray(audio, dtype=np.float32)

    with model.timers.stage("mel"):
        # openai pads 30 s of zeros at the end so the last window is full.
        padded = np.pad(audio, (0, N_SAMPLES_PER_CHUNK))
        center = opts.mel_mode == "openai"
        n_frames_total = frame_count(len(padded), center=center)
        mel = log_mel_spectrogram(
            torch.from_numpy(padded).to(model.device), model.filters, n_frames_total,
            center=center, fold=not center,
        )
        _sync(model.device)
    auto_ctx = opts.audio_ctx == "auto"
    n_frames_window = 2 * (cfg.n_audio_ctx if auto_ctx
                           else (opts.audio_ctx or cfg.n_audio_ctx))
    # Frames holding real audio: subtract the fixed 30 s zero pad (openai's
    # content_frames = mel.shape[-1] - N_FRAMES), NOT the window length,
    # which opts.audio_ctx can shrink below the pad.
    content_frames = mel.shape[-1] - N_SAMPLES_PER_CHUNK // HOP_LENGTH

    # Clip range: frames are HOP_LENGTH / SAMPLE_RATE = 10 ms each
    seek_start = max(0, opts.offset_ms // 10)
    if opts.duration_ms is not None:
        content_frames = min(content_frames, seek_start + opts.duration_ms // 10)

    def _window_frames(seek: int) -> int:
        """Per-window frame count: full ctx, or (auto mode) the remaining
        content rounded up to 512-frame buckets, full windows untouched."""
        if not auto_ctx:
            return n_frames_window
        remaining = max(content_frames - seek, 1)
        return min(n_frames_window, max(512, -(-remaining // 512) * 512))

    # Language detection on the first window of the clip (multilingual only).
    language = opts.language
    first_enc = None  # the language-ID encoding, reused by the first window
    if language is None:
        if not cfg.is_multilingual:
            language = "en"
        else:
            with model.timers.stage("lang_id"):
                window = mel_window(mel, seek_start, _window_frames(seek_start))[None]
                first_enc = model.encoder(window)
                langs, _ = detect_language(model.decoder, vocab, first_enc.cross_k,
                                           first_enc.cross_v)
                _sync(model.device)
            language = langs[0]
            log.info("detected language: %s", language)
    opts = dataclasses.replace(opts, language=language)

    all_tokens: List[int] = []
    all_segments: List[Segment] = []
    prompt_reset_since = 0
    if opts.initial_prompt is not None:
        all_tokens.extend(_tokenize_prompt(vocab, opts.initial_prompt))

    seek = seek_start
    while seek < content_frames:
        segments, seek, new_tokens, reset_prompt = _window_step(
            model, mel, seek, content_frames, _window_frames(seek), opts,
            all_tokens, prompt_reset_since, len(all_segments), language, enc=first_enc,
        )
        first_enc = None
        all_segments.extend(segments)
        if opts.verbose:
            for seg in segments:
                log.info("[%.2fs -> %.2fs] %s", seg.t0, seg.t1, seg.text)
        all_tokens.extend(new_tokens)
        if reset_prompt:
            prompt_reset_since = len(all_tokens)

    if opts.token_timestamps:
        from .timestamps import add_token_timestamps

        add_token_timestamps(all_segments, vocab, audio)

    text = "".join(seg.text for seg in all_segments)
    return {
        "text": text,
        "segments": [dataclasses.asdict(s) for s in all_segments],
        "language": language,
        "duration": len(audio) / SAMPLE_RATE,
    }


def _window_step(
    model: WhisperModel,
    mel: torch.Tensor,
    seek: int,
    content_frames: int,
    n_frames_window: int,
    opts: TranscribeOptions,
    all_tokens: List[int],
    prompt_reset_since: int,
    segment_id_base: int,
    language: Optional[str],
    enc=None,
):
    """Process ONE window at ``seek``: encode, fallback decode, segment
    extraction, seek advancement, prompt bookkeeping. ``enc`` skips the
    encoder when the caller already encoded this window (the lang-ID pass).

    Returns (segments, new_seek, new_tokens, reset_prompt).
    """
    with model.timers.stage("encode"):
        if enc is None:
            enc = model.encoder(mel_window(mel, seek, n_frames_window)[None])
            _sync(model.device)

    prompt = all_tokens[prompt_reset_since:] if opts.condition_on_previous_text else []
    with model.timers.stage("decode"):
        result = _decode_with_fallback(model, enc.cross_k, enc.cross_v, opts, prompt)

    return finish_window(
        model, result, seek, content_frames, n_frames_window, opts,
        segment_id_base, language, enc=enc,
    )


def finish_window(
    model: WhisperModel,
    result: DecodingResult,
    seek: int,
    content_frames: int,
    n_frames_window: int,
    opts: TranscribeOptions,
    segment_id_base: int,
    language: Optional[str],
    enc=None,
):
    """Post-decode bookkeeping for ONE window: no-speech skip, segment
    extraction from timestamp tokens, seek advancement, prompt-reset rule.
    ``enc`` (the window's encoder output) is only needed for
    opts.word_timestamps.

    Returns (segments, new_seek, new_tokens, reset_prompt).
    """
    cfg, vocab = model.config, model.vocab
    time_offset = seek * HOP_LENGTH / SAMPLE_RATE
    segment_size = min(n_frames_window, content_frames - seek)
    segment_duration = segment_size * HOP_LENGTH / SAMPLE_RATE

    if opts.no_speech_threshold is not None:
        should_skip = result.no_speech_prob > opts.no_speech_threshold
        if (
            opts.logprob_threshold is not None
            and result.avg_logprob > opts.logprob_threshold
        ):
            should_skip = False  # confident despite no_speech: keep
        if should_skip:
            return [], seek + segment_size, [], False

    previous_seek = seek
    segments: List[Segment] = []
    tokens = np.array(result.tokens)
    timestamp_tokens = tokens >= vocab.token_beg
    single_timestamp_ending = (
        len(tokens) >= 2 and not timestamp_tokens[-2] and timestamp_tokens[-1]
    )
    consecutive = np.where(timestamp_tokens[:-1] & timestamp_tokens[1:])[0] + 1

    def add_segment(start, end, seg_tokens):
        text_tokens = [t for t in seg_tokens if t < vocab.token_eot]
        segments.append(
            Segment(
                id=segment_id_base + len(segments),
                seek=previous_seek,
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

    if len(consecutive) > 0:
        # Segments delimited by paired timestamps inside the window.
        slices = consecutive.tolist()
        if single_timestamp_ending:
            slices.append(len(tokens))
        last_slice = 0
        for current_slice in slices:
            sliced = tokens[last_slice:current_slice]
            start_pos = sliced[0].item() - vocab.token_beg
            end_pos = sliced[-1].item() - vocab.token_beg
            add_segment(
                time_offset + start_pos * 0.02,
                time_offset + end_pos * 0.02,
                sliced.tolist(),
            )
            last_slice = current_slice
        if single_timestamp_ending:
            seek += segment_size  # window fully consumed
        else:
            last_timestamp_pos = tokens[last_slice - 1].item() - vocab.token_beg
            seek += last_timestamp_pos * INPUT_STRIDE
    else:
        duration = segment_duration
        timestamps = tokens[timestamp_tokens]
        if len(timestamps) > 0 and timestamps[-1].item() != vocab.token_beg:
            duration = (timestamps[-1].item() - vocab.token_beg) * 0.02
        add_segment(time_offset, time_offset + duration, tokens.tolist())
        seek += segment_size

    if seek <= previous_seek:
        # Degenerate timestamps (e.g. all <|0.00|>) must not stall the loop.
        log.warning("seek did not advance at frame %d; forcing full-window step", previous_seek)
        seek = previous_seek + segment_size

    if opts.word_timestamps and segments and enc is not None:
        from .word_timing import find_word_timestamps

        sot_seq = [vocab.token_sot]
        if cfg.is_multilingual:
            sot_seq.append(vocab.language_token(language or "en"))
            sot_seq.append(
                vocab.token_translate if opts.task == "translate"
                else vocab.token_transcribe
            )
        with model.timers.stage("word_align"):
            words = find_word_timestamps(
                model.decoder, vocab, enc.cross_k, enc.cross_v,
                [t for s in segments for t in s.tokens],
                sot_seq, num_frames=segment_size // INPUT_STRIDE,
                time_offset=time_offset,
            )
            _sync(model.device)
        # distribute words into segments in order by midpoint time
        wi = 0
        for s in segments:
            s.words = []
            while wi < len(words):
                w = words[wi]
                mid = (w.start + w.end) / 2
                if mid >= s.t1 and s is not segments[-1]:
                    break
                s.words.append(dataclasses.asdict(w))
                wi += 1

    reset_prompt = (
        not opts.condition_on_previous_text or result.temperature > 0.5
    )
    # Prompt carry = COMMITTED segment tokens only (openai transcribe.py
    # extends all_tokens with segment tokens): on a seek-rewind (no
    # single-timestamp ending) the un-segmented tail is re-decoded by the
    # next window and must not already sit in its conditioning prompt.
    new_tokens = [t for s in segments for t in s.tokens]
    return segments, seek, new_tokens, reset_prompt


def _tokenize_prompt(vocab, text: str) -> List[int]:
    """Prompt text -> token ids.

    Exact GPT-2 byte-level BPE when the vocab is a real BPE table (the
    merges rebuilt from the GGML id table, ``io.bpe``), so conditioning is
    token-identical to openai-whisper; synthetic (non-BPE) vocabs take
    greedy longest-match. As openai's transcribe.py, a leading space is
    prepended.
    """
    return vocab.encode(" " + text.strip())
