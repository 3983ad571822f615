"""PCM ingestion: WAV -> float32 mono 16 kHz.

The port's own copy of ``whisper_tpu/io/wav.py``: i16 -> f32 by /32768,
multichannel audio downmixed, other rates resampled (scipy's
``resample_poly``). ``load_wav`` reads through the native C++ runtime
(``runtime/native.py``) and takes scipy's reader only when the runtime is
unavailable; ``load_wav_bytes`` parses an in-memory WAV.
"""

from __future__ import annotations

import numpy as np

from ..config import SAMPLE_RATE
from ..errors import AudioError


def convert_integer_to_float_audio(samples: np.ndarray) -> np.ndarray:
    """i16 PCM -> f32 in [-1, 1) by /32768."""
    return samples.astype(np.float32) / 32768.0


def _finish_load(rate: int, audio: np.ndarray, target_rate: int,
                 resample: bool, what: str) -> np.ndarray:
    """Shared tail of every WAV ingest path: resample-or-reject to
    ``target_rate`` (audio already mono f32)."""
    if rate != target_rate:
        if not resample:
            raise AudioError(f"{what} is {rate} Hz, expected {target_rate} Hz")
        audio = resample_poly(audio, target_rate, rate)
    return audio


def load_wav(path: str, target_rate: int = SAMPLE_RATE, resample: bool = True) -> np.ndarray:
    """Read a WAV file and return mono f32 PCM at ``target_rate``."""
    from ..runtime import native

    out = native.native_load_wav(path)
    if out is not None:
        rate, audio = out
    else:
        from scipy.io import wavfile

        try:
            rate, data = wavfile.read(path)
        except Exception as e:  # noqa: BLE001
            raise AudioError(f"cannot read WAV {path!r}: {e}") from e
        native.count("wav-python")
        audio = _to_float_mono(data)
    return _finish_load(rate, audio, target_rate, resample, repr(path))


def load_wav_bytes(data: bytes, target_rate: int = SAMPLE_RATE,
                   resample: bool = True) -> np.ndarray:
    """In-memory WAV bytes -> mono f32 PCM at ``target_rate`` (no temporary
    file)."""
    import io as _io

    from scipy.io import wavfile

    try:
        rate, raw = wavfile.read(_io.BytesIO(data))
    except Exception as e:  # noqa: BLE001
        raise AudioError(f"cannot parse WAV body: {e}") from e
    return _finish_load(rate, _to_float_mono(raw), target_rate, resample, "WAV body")


def _to_float_mono(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        audio = convert_integer_to_float_audio(data)
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    elif data.dtype in (np.float32, np.float64):
        audio = data.astype(np.float32)
    else:
        raise AudioError(f"unsupported WAV sample dtype {data.dtype}")
    if audio.ndim == 2:  # downmix channels
        audio = audio.mean(axis=1)
    return audio


def resample_poly(audio: np.ndarray, up_rate: int, down_rate: int) -> np.ndarray:
    from math import gcd

    from scipy import signal

    g = gcd(up_rate, down_rate)
    return signal.resample_poly(audio, up_rate // g, down_rate // g).astype(np.float32)


def write_wav(path: str, audio: np.ndarray, rate: int = SAMPLE_RATE) -> None:
    """Write mono PCM as a 16-bit WAV (f32 input is clipped to [-1, 1])."""
    import wave

    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = (np.clip(audio.astype(np.float32), -1.0, 1.0) * 32767.0
                 ).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(audio.tobytes())
