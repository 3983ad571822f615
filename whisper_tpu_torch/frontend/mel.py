"""Log-mel spectrogram frontend in PyTorch.

Port of ``whisper_tpu/frontend/mel.py``: the 400-point real DFT stays two
f32 (400, 201) matrix products plus the filterbank product, over all frames
at once, in both parity modes (``center=True, fold=False``: openai-whisper;
``center=False, fold=True``: whisper.cpp-1.0.3) and with ``speed_up``.
``mel_filter_bank`` is a numpy copy of the Slaney filterbank, so the port
needs neither jax nor transformers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import HOP_LENGTH, N_FFT

_N_BINS = N_FFT // 2 + 1  # 201


@functools.lru_cache(maxsize=4)
def _dft_matrices_np(n_fft: int = N_FFT):
    """Real-DFT basis: C[j,k]=cos(2*pi*j*k/N), S[j,k]=-sin(...), k=0..N/2."""
    j = np.arange(n_fft)[:, None].astype(np.float64)
    k = np.arange(n_fft // 2 + 1)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * j * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def hann_window_np(n_fft: int = N_FFT) -> np.ndarray:
    """Periodic Hann, 0.5*(1-cos(2*pi*i/N))."""
    i = np.arange(n_fft, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n_fft))).astype(np.float32)


def frame_count(n_samples: int, center: bool = True) -> int:
    # Both modes give n // hop frames (openai drops the last centred frame).
    return n_samples // HOP_LENGTH


@functools.lru_cache(maxsize=8)
def _device_constants(device: torch.device):
    """Hann window, the DFT basis and the fold weights on ``device``, copied
    there once (normal tensors, also when first asked for under inference
    mode)."""
    cos_np, sin_np = _dft_matrices_np()
    fold = np.full(_N_BINS, 2.0, np.float32)
    fold[[0, -1]] = 1.0
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device)
                     for a in (hann_window_np(), cos_np, sin_np, fold))


@functools.lru_cache(maxsize=16)
def _reflect_index(n: int, device: torch.device) -> torch.Tensor:
    """numpy's "reflect" padding of ``n`` samples by N_FFT // 2 each side
    (no edge repeat, any length, as jnp.pad does; F.pad(mode="reflect")
    would refuse audio shorter than the pad), as a gather index."""
    idx = np.pad(np.arange(n), (N_FFT // 2, N_FFT // 2), mode="reflect")
    with torch.inference_mode(False):
        return torch.from_numpy(idx).to(device)


def log_mel_spectrogram(
    audio: torch.Tensor,
    filters: torch.Tensor,
    n_frames: int,
    center: bool = True,
    fold: bool = False,
    speed_up: bool = False,
) -> torch.Tensor:
    """audio (..., n_samples) f32, filters (n_mel, 201) -> mel (..., n_mel,
    n_frames), on audio's device; each leading row is its own clip (its own
    reflect padding and max normalisation). ``n_frames`` must be
    ``frame_count(n_samples, center)``."""
    audio = audio.float()
    dev = audio.device
    hann, cos, sin, foldv = _device_constants(dev)
    padded = audio[..., _reflect_index(audio.shape[-1], dev)] if center else audio
    # Zero-pad the tail so every frame is in bounds.
    need = (n_frames - 1) * HOP_LENGTH + N_FFT
    padded = torch.nn.functional.pad(padded, (0, max(0, need - padded.shape[-1])))

    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[..., :n_frames, :] * hann
    re = frames @ cos  # (..., n_frames, 201)
    im = frames @ sin
    power = re * re + im * im

    if fold:
        # whisper.cpp-1.0.3's symmetric-bin fold: doubles bins 1..199 only.
        power = power * foldv

    if speed_up:
        # Average adjacent power bins; filters must then span n_fft//4 + 1 bins.
        power = 0.5 * (power[..., 0:-1:2] + power[..., 1::2])  # (..., n_frames, 100)
        power = torch.nn.functional.pad(power, (0, 1))        # bin n_fft/4 -> 101

    filters = filters.to(device=dev, dtype=torch.float32)
    mel = power[..., : filters.shape[1]] @ filters.T  # (..., n_frames, n_mel)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.transpose(-1, -2)  # mel-major (..., n_mel, n_frames)


def mel_window(mel: torch.Tensor, offset: int, n_frames_window: int) -> torch.Tensor:
    """``n_frames_window`` frames from ``offset``, zero-padded past the end."""
    n_mel, n_len = mel.shape
    out = torch.zeros((n_mel, n_frames_window), dtype=mel.dtype, device=mel.device)
    i0 = min(offset, n_len)
    i1 = min(offset + n_frames_window, n_len)
    if i1 > i0:
        out[:, : i1 - i0] = mel[:, i0:i1]
    return out


def mel_filter_bank(n_mels: int = 80, n_fft: int = N_FFT, sample_rate: int = 16000) -> np.ndarray:
    """Slaney-normalised mel filterbank, (n_mels, n_fft//2+1) f32: the
    librosa/openai ``mel_filters`` matrix, as transformers' ``mel_filter_bank``
    computes it with ``norm="slaney", mel_scale="slaney"``."""

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mels = 3.0 * f / 200.0
        log = f >= 1000.0
        return np.where(log, 15.0 + np.log(np.maximum(f, 1e-300) / 1000.0) * (27.0 / np.log(6.4)),
                        mels)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = 200.0 * m / 3.0
        log = m >= 15.0
        return np.where(log, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), f)

    n_bins = n_fft // 2 + 1
    mel_freqs = np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), n_mels + 2)
    filter_freqs = mel_to_hz(mel_freqs)
    fft_freqs = np.linspace(0, sample_rate // 2, n_bins)
    filter_diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / filter_diff[:-1]
    up = slopes[:, 2:] / filter_diff[1:]
    bank = np.maximum(0.0, np.minimum(down, up))  # (n_bins, n_mels)
    bank *= (2.0 / (filter_freqs[2: n_mels + 2] - filter_freqs[:n_mels]))[None, :]
    return bank.T.astype(np.float32)
