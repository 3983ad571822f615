"""Lockstep batched transcription of many 30 s windows.

Port of ``whisper_tpu/parallel/serving.py`` on one device: mel for every
stream, one batched encoder forward, then all streams decode in lockstep
(finished streams are frozen at EOT until the batch drains): greedy on the
device loop; beam search (or best_of) options on the host loop, as the JAX
package routes them. A device mesh (tensor parallelism) is not ported yet
and raises. ``auto_engine`` builds a ``BatchTranscriber`` on the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..decoding.result import DecodingResult
from ..decoding.task import DecodingOptions, decode_full
from ..frontend.mel import frame_count, log_mel_spectrogram, mel_window
from ..model.load import WhisperModel

N_FRAMES = 3000


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BatchTranscriber:
    """Fixed-batch transcription engine on the model's device."""

    def __init__(self, model: WhisperModel, batch_size: int, mesh=None,
                 options: Optional[DecodingOptions] = None):
        if mesh is not None:
            raise NotImplementedError("tensor-parallel serving is not ported yet")
        self.model = model
        self.batch_size = batch_size
        self.options = options or DecodingOptions(without_timestamps=True)

    def _mel_batch(self, audios: Sequence[np.ndarray]) -> torch.Tensor:
        cfg, dev = self.model.config, self.model.device
        n_window = N_FRAMES if cfg.n_audio_ctx == 1500 else 2 * cfg.n_audio_ctx
        out = []
        for audio in audios:
            a = torch.as_tensor(np.asarray(audio, dtype=np.float32)).to(dev)
            mel = log_mel_spectrogram(a, self.model.filters, frame_count(len(audio)))
            out.append(mel_window(mel, 0, n_window))
        return torch.stack(out)

    def transcribe_batch(self, audios: Sequence[np.ndarray]) -> List[DecodingResult]:
        """One 30 s window per stream, all streams in lockstep. Stage wall
        times (each ending in a device synchronise) go to ``model.timers``."""
        model = self.model
        if len(audios) != self.batch_size:
            raise ValueError(f"expected {self.batch_size} streams, got {len(audios)}")
        with torch.inference_mode():
            with model.timers.stage("mel"):
                mel = self._mel_batch(audios)
                _sync(model.device)
            with model.timers.stage("encode"):
                enc = model.encoder(mel)
                _sync(model.device)
            use_device = self.options.beam_size is None and (self.options.best_of or 1) == 1
            with model.timers.stage("decode"):
                return decode_full(model.decoder, model.vocab, enc.cross_k, enc.cross_v,
                                   self.options, use_device_loop=use_device)


def auto_engine(model: WhisperModel, batch_size: int = 8, tp: Optional[int] = None
                ) -> BatchTranscriber:
    """A ``BatchTranscriber`` over the model's device, as JAX's auto_engine
    builds one over every visible device: here one card, so no mesh. A
    tensor-parallel split (``tp`` > 1) raises: that is ROADMAP item 16."""
    if tp is not None and tp > 1:
        raise NotImplementedError(
            f"auto_engine(tp={tp}) needs tensor parallelism (parallel/{{mesh,sharding}}.py), "
            "which the port does not have yet (ROADMAP item 16)")
    return BatchTranscriber(model, batch_size)
