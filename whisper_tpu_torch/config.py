"""Model configuration: the GGML hyperparameter header and the presets.

The port's own copy of what it reads from ``whisper_tpu/config.py`` (that
module is JAX-free, but the port imports nothing of the JAX package): the
11-field i32 GGML header as a frozen dataclass, the audio frontend
constants, the released models' presets and the weight-size estimate the
loader logs. The TPU HBM budget and the alignment heads are not copied:
nothing in the port reads them yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

# Audio frontend constants.
SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SIZE = 30  # seconds per window
N_SAMPLES_PER_CHUNK = SAMPLE_RATE * CHUNK_SIZE  # 480_000

# n_audio_layer -> model family name; large-v3 shares n_audio_layer=32 with
# large and is told apart by n_mels.
_AUDIO_LAYER_TO_NAME = {4: "tiny", 6: "base", 12: "small", 24: "medium", 32: "large"}


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Whisper hyperparameters, one field per GGML header i32."""

    n_vocab: int = 51864
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    n_mels: int = 80
    f16: int = 1

    # Build-side knob (not part of the GGML header): "erf" matches
    # openai/whisper, "tanh" ggml's approximate GELU.
    gelu_impl: str = "erf"

    @property
    def model_type(self) -> str:
        name = _AUDIO_LAYER_TO_NAME.get(self.n_audio_layer, "unknown")
        if name == "large" and self.n_mels == 128:
            name = "large-v3-turbo" if self.n_text_layer == 4 else "large-v3"
        return name

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def d_head_audio(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def d_head_text(self) -> int:
        return self.n_text_state // self.n_text_head

    def validate(self) -> "WhisperConfig":
        if self.n_audio_state % self.n_audio_head:
            raise ValueError("n_audio_state must be divisible by n_audio_head")
        if self.n_text_state % self.n_text_head:
            raise ValueError("n_text_state must be divisible by n_text_head")
        if self.n_mels not in (80, 128):
            raise ValueError(f"unsupported n_mels={self.n_mels}")
        return self

    def hbm_bytes_estimate(self) -> int:
        """Analytic size of the weights as stored (f16 or f32 matrices, f32
        vectors and embeddings), for the loader's log line."""
        ws = 2 if self.f16 == 1 else 4
        f32 = 4
        a, t, v, m = self.n_audio_state, self.n_text_state, self.n_vocab, self.n_mels
        size = 0
        size += self.n_audio_ctx * a * f32  # encoder positional embedding
        size += 3 * m * a * ws + a * f32  # conv1
        size += 3 * a * a * ws + a * f32  # conv2
        size += 2 * a * f32  # ln_post
        size += self.n_text_ctx * t * f32 + v * t * ws + 2 * t * f32  # decoder embeddings
        size += self.n_audio_layer * (4 * a * a * ws + 8 * a * a * ws + 10 * a * f32)
        size += self.n_text_layer * (8 * t * t * ws + 8 * t * t * ws + 16 * t * f32)
        return size


# Canonical configs of the released model families (header values of the
# released GGML files).
PRESETS: Dict[str, WhisperConfig] = {
    "tiny.en": WhisperConfig(51864, 1500, 384, 6, 4, 448, 384, 6, 4, 80, 1),
    "tiny": WhisperConfig(51865, 1500, 384, 6, 4, 448, 384, 6, 4, 80, 1),
    "base.en": WhisperConfig(51864, 1500, 512, 8, 6, 448, 512, 8, 6, 80, 1),
    "base": WhisperConfig(51865, 1500, 512, 8, 6, 448, 512, 8, 6, 80, 1),
    "small.en": WhisperConfig(51864, 1500, 768, 12, 12, 448, 768, 12, 12, 80, 1),
    "small": WhisperConfig(51865, 1500, 768, 12, 12, 448, 768, 12, 12, 80, 1),
    "medium.en": WhisperConfig(51864, 1500, 1024, 16, 24, 448, 1024, 16, 24, 80, 1),
    "medium": WhisperConfig(51865, 1500, 1024, 16, 24, 448, 1024, 16, 24, 80, 1),
    # large (v1) and v2 share every header field
    "large": WhisperConfig(51865, 1500, 1280, 20, 32, 448, 1280, 20, 32, 80, 1),
    "large-v2": WhisperConfig(51865, 1500, 1280, 20, 32, 448, 1280, 20, 32, 80, 1),
    "large-v3": WhisperConfig(51866, 1500, 1280, 20, 32, 448, 1280, 20, 32, 128, 1),
    # v3 with the decoder pruned to 4 layers
    "large-v3-turbo": WhisperConfig(51866, 1500, 1280, 20, 32, 448, 1280, 20, 4, 128, 1),
}
