"""Streaming (real-time) transcription: feed PCM incrementally, read results.

Port of ``whisper_tpu/pipeline/streaming.py``. The offline sliding-window
loop (``pipeline/transcribe.py``) is causal: each window depends only on
samples up to ``seek + 30 s`` and on the previous windows' tokens. Streaming
therefore reuses the same window step (``transcribe._window_step``) and
differs only in scheduling:

  * ``feed(pcm)`` appends samples; whenever a full 30 s window (plus the mel
    centering context) is available past the committed ``seek``, the window
    is decoded and its segments committed exactly as offline would;
  * the pending partial window is decoded as a draft (advisory, re-issued on
    every feed, never part of the final transcript), zero-padded the way
    offline pads the file tail;
  * ``finalize()`` decodes the remaining tail and returns the full result.

Exactness: offline normalizes the log-mel against the global spectral max of
the file; streaming commits with the max over the audio seen so far. If a
louder section arrives after a window was committed, ``finalize()`` detects
the drift and re-runs the offline pipeline, so the final transcript always
equals ``transcribe(model, full_audio)``: streaming changes latency, never
output. Each window runs on the model's device as in ``transcribe`` (K1 in
the encoder, K5 at every decoder forward).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..config import HOP_LENGTH, N_SAMPLES_PER_CHUNK, SAMPLE_RATE
from ..decoding.result import Segment
from ..frontend.mel import frame_count, log_mel_spectrogram
from ..model.load import WhisperModel
from .transcribe import TranscribeOptions, _tokenize_prompt, _window_step


class StreamingTranscriber:
    """Incremental transcription with offline-identical final output."""

    def __init__(
        self,
        model: WhisperModel,
        options: Optional[TranscribeOptions] = None,
        draft: bool = True,
        **kwargs,
    ):
        opts = options or TranscribeOptions(**kwargs)
        if opts.language is None and model.config.is_multilingual:
            raise ValueError(
                "streaming requires an explicit language= (detection would "
                "peek at audio that hasn't arrived)")
        if opts.audio_ctx == "auto":
            # per-window auto derivation needs the total content length,
            # which streaming by definition does not have yet
            raise ValueError(
                "audio_ctx='auto' is offline-only (transcribe); streaming "
                "windows must use a fixed audio_ctx")
        if opts.offset_ms or opts.duration_ms is not None:
            # Committed windows always start at 0; honoring a clip range
            # only in the finalize()-drift re-run would break the
            # finalize()==transcribe() contract. Clip the feed instead.
            raise ValueError(
                "offset_ms/duration_ms are not supported in streaming — "
                "clip the PCM you feed() instead")
        self.model = model
        self.opts = dataclasses.replace(
            opts, language=opts.language or "en")
        self.draft = draft
        self._audio = np.zeros(0, np.float32)
        self._seek = 0                  # committed mel-frame position
        self._segments: List[Segment] = []
        self._all_tokens: List[int] = []
        self._prompt_reset_since = 0
        self._commit_maxes: List[float] = []  # mel max used per commit
        self._finalized: Optional[dict] = None
        if self.opts.initial_prompt is not None:
            self._all_tokens.extend(
                _tokenize_prompt(model.vocab, self.opts.initial_prompt))

    # -- internals --

    def _mel_so_far(self, pad_tail: bool) -> torch.Tensor:
        """Log-mel over received audio (optionally padded like the offline
        file tail), on the model's device."""
        audio = self._audio
        if pad_tail:
            audio = np.pad(audio, (0, N_SAMPLES_PER_CHUNK))
        center = self.opts.mel_mode == "openai"
        mel = log_mel_spectrogram(
            torch.from_numpy(audio).to(self.model.device), self.model.filters,
            frame_count(len(audio), center=center),
            center=center, fold=not center,
        )
        return mel

    def _commit_ready_windows(self) -> List[Segment]:
        """Decode every full window available past the committed seek."""
        n_frames_window = 2 * (self.opts.audio_ctx or self.model.config.n_audio_ctx)
        committed: List[Segment] = []
        # A window at seek needs samples through (seek + window) frames plus
        # the mel frame context: center=True reads N_FFT/2 = 200 samples of
        # reflection context; center=False (reference mode) reads the last
        # frame's full N_FFT window, i.e. N_FFT - HOP = 240 samples past the
        # frame grid — under-provisioning would zero-pad samples offline
        # computes from real audio, silently breaking finalize() identity.
        margin = 200 if self.opts.mel_mode == "openai" else 240
        mel = None  # audio is fixed within one feed(): compute mel once
        while True:
            need = (self._seek + n_frames_window) * HOP_LENGTH + margin
            if len(self._audio) < need:
                break
            if mel is None:
                mel = self._mel_so_far(pad_tail=False)
                # the max on the device: only a scalar reaches the host
                mel_max = float(mel.max())
            self._commit_maxes.append(mel_max)
            segments, self._seek, new_tokens, reset = _window_step(
                self.model, mel, self._seek,
                content_frames=mel.shape[-1],  # full window guaranteed
                n_frames_window=n_frames_window,
                opts=self.opts,
                all_tokens=self._all_tokens,
                prompt_reset_since=self._prompt_reset_since,
                segment_id_base=len(self._segments),
                language=self.opts.language,
            )
            self._segments.extend(segments)
            committed.extend(segments)
            self._all_tokens.extend(new_tokens)
            if reset:
                self._prompt_reset_since = len(self._all_tokens)
        return committed

    def _draft_tail(self) -> List[dict]:
        """Advisory decode of the pending partial window (not committed)."""
        if len(self._audio) <= self._seek * HOP_LENGTH:
            return []
        mel = self._mel_so_far(pad_tail=True)
        n_frames_window = 2 * (self.opts.audio_ctx or self.model.config.n_audio_ctx)
        content = max(
            self._seek + 1,
            int(frame_count(len(self._audio), center=self.opts.mel_mode == "openai")),
        )
        segments, _, _, _ = _window_step(
            self.model, mel, self._seek,
            content_frames=content,
            n_frames_window=n_frames_window,
            opts=self.opts,
            all_tokens=self._all_tokens,
            prompt_reset_since=self._prompt_reset_since,
            segment_id_base=0,
            language=self.opts.language,
        )
        return [dataclasses.asdict(s) for s in segments]

    # -- public API --

    @torch.inference_mode()
    def feed(self, pcm: np.ndarray) -> dict:
        """Append 16 kHz f32 samples; returns newly committed segments and a
        draft of the pending tail."""
        if self._finalized is not None:
            raise RuntimeError("finalize() already called")
        self._audio = np.concatenate(
            [self._audio, np.asarray(pcm, np.float32)])
        committed = self._commit_ready_windows()
        out = {
            "committed": [dataclasses.asdict(s) for s in committed],
            "draft": self._draft_tail() if self.draft else [],
            "committed_seconds": self._seek * HOP_LENGTH / SAMPLE_RATE,
        }
        return out

    @torch.inference_mode()
    def finalize(self) -> dict:
        """Flush the tail; the result equals offline transcribe() exactly."""
        if self._finalized is not None:
            return self._finalized
        from .transcribe import transcribe

        final_mel = self._mel_so_far(pad_tail=True)
        final_max = float(final_mel.max())
        drift = any(abs(m - final_max) > 1e-6 for m in self._commit_maxes)
        if drift:
            # a later, louder section changed the global mel normalization —
            # committed windows were decoded against a stale max. Re-run the
            # offline pipeline (identical by construction) for exactness.
            self._finalized = transcribe(self.model, self._audio, self.opts)
            return self._finalized

        # decode the remaining tail against the final (padded) mel
        n_frames_window = 2 * (self.opts.audio_ctx or self.model.config.n_audio_ctx)
        # real-audio frames: subtract the fixed 30 s pad, not the window
        # length (which audio_ctx can shrink) — mirrors transcribe()
        content_frames = final_mel.shape[-1] - N_SAMPLES_PER_CHUNK // HOP_LENGTH
        while self._seek < content_frames:
            segments, self._seek, new_tokens, reset = _window_step(
                self.model, final_mel, self._seek,
                content_frames=content_frames,
                n_frames_window=n_frames_window,
                opts=self.opts,
                all_tokens=self._all_tokens,
                prompt_reset_since=self._prompt_reset_since,
                segment_id_base=len(self._segments),
                language=self.opts.language,
            )
            self._segments.extend(segments)
            self._all_tokens.extend(new_tokens)
            if reset:
                self._prompt_reset_since = len(self._all_tokens)

        if self.opts.token_timestamps:
            from .timestamps import add_token_timestamps

            add_token_timestamps(self._segments, self.model.vocab, self._audio)

        self._finalized = {
            "text": "".join(s.text for s in self._segments),
            "segments": [dataclasses.asdict(s) for s in self._segments],
            "language": self.opts.language,
            "duration": len(self._audio) / SAMPLE_RATE,
        }
        return self._finalized
