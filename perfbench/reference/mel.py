"""openai's log-mel frontend: a centred 400-point STFT with a periodic Hann
window, hop 160, the last frame dropped, librosa's Slaney mel filters, log10
clamped at 1e-10, floored 8 below the clip's maximum, then (x + 4) / 4."""

from __future__ import annotations

import numpy as np
import torch

N_FFT, HOP, SAMPLE_RATE, CHUNK_SAMPLES = 400, 160, 16000, 480000


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    lin = f / (200.0 / 3.0)
    logstep = np.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-12) / 1000.0) / logstep, lin)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)), m * (200.0 / 3.0))


def mel_filters(n_mels: int) -> np.ndarray:
    """librosa.filters.mel(sr=16000, n_fft=400, n_mels, htk=False,
    norm="slaney"), (n_mels, 201) float32."""
    fft_freqs = np.linspace(0.0, SAMPLE_RATE / 2, 1 + N_FFT // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    w = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        w[i] = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    return w.astype(np.float32)


def padded_length(n_samples: int) -> int:
    """A request's audio with 30 s of zeros after it, rounded up to whole
    30 s chunks: the length the served path takes the log-mel of."""
    return -(-(n_samples + CHUNK_SAMPLES) // CHUNK_SAMPLES) * CHUNK_SAMPLES


def log_mel(pcm16: np.ndarray, n_mels: int, device) -> torch.Tensor:
    """(n_mels, frames) float32 of int16 PCM zero-padded to
    ``padded_length``, normalised over the whole padded clip."""
    audio = np.zeros(padded_length(len(pcm16)), np.float32)
    audio[: len(pcm16)] = pcm16.astype(np.float32) / 32768.0
    x = torch.from_numpy(audio).to(device)
    window = torch.hann_window(N_FFT, device=device, dtype=torch.float32)
    stft = torch.stft(x, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    power = stft[..., :-1].abs() ** 2
    filters = torch.from_numpy(mel_filters(n_mels)).to(device)
    log_spec = torch.clamp(filters @ power, min=1e-10).log10()
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def window(mel: torch.Tensor, seek: int, frames: int = 3000) -> torch.Tensor:
    """``frames`` mel frames from ``seek``, zero past the end."""
    out = torch.zeros((mel.shape[0], frames), dtype=mel.dtype, device=mel.device)
    piece = mel[:, seek: seek + frames]
    out[:, : piece.shape[1]] = piece
    return out
