"""Model configuration: the GGML hyperparameter header and the presets.

The port's own copy of what it reads from ``whisper_tpu/config.py`` (that
module is JAX-free, but the port imports nothing of the JAX package): the
11-field i32 GGML header as a frozen dataclass, the audio frontend
constants, the released models' presets, the weight-size estimate the
loader logs, the published alignment heads of word timing, and the serving
memory estimate with its guard (``check_serving_hbm``), budgeted from the
card's own memory.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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

    def serving_hbm_estimate(
        self,
        batch: int = 1,
        ctx: Optional[int] = None,
        dtype_bytes: int = 2,
        kv_dtype_bytes: int = 2,
        beam: int = 1,
        enc_batch: Optional[int] = None,
        engine: bool = False,
    ) -> Dict[str, int]:
        """Device bytes of a serving configuration, term by term: weights,
        cross memory, self-KV cache, peak encoder activations and
        transients. ``batch`` counts streams (beam groups): the cross memory
        is group-shared, so cross rows = batch while KV rows = batch * beam.
        ``enc_batch`` is the encode batch (defaults to batch). ``engine``
        adds an admission bucket's cross and KV rows beside the resident
        pools; beam > 1 adds one full KV copy (the out-of-place fork
        permute). The JAX package's formula, term for term."""
        c = min(ctx if ctx is not None else self.n_text_ctx, self.n_text_ctx)
        t, a = self.n_text_state, self.n_audio_state
        eb = min(enc_batch if enc_batch is not None else batch, batch)

        def cross_rows(n: int) -> int:
            b = 2 * self.n_text_layer * n * a * self.n_audio_ctx * kv_dtype_bytes
            if kv_dtype_bytes == 1:  # int8 adds per-position f32 scales
                b += (2 * self.n_text_layer * n * self.n_text_head
                      * self.n_audio_ctx * 4)
            return b

        def kv_rows(n: int) -> int:
            b = 2 * self.n_text_layer * n * t * c * kv_dtype_bytes
            if kv_dtype_bytes == 1:
                b += 2 * self.n_text_layer * n * self.n_text_head * c * 4
            return b

        cross = cross_rows(batch)
        kv = kv_rows(batch * beam)
        # encoder peak: ~4 live (B, 1500, a) activations + one (B, 1500, 4a)
        acts = eb * self.n_audio_ctx * a * (4 + 4) * dtype_bytes
        transient = 0
        if engine:  # admission bucket rows alongside the resident pools
            transient += cross_rows(eb) + kv_rows(eb * beam)
        if beam > 1:  # out-of-place full-pool permute
            transient += kv_rows(batch * beam)
        weights = self.hbm_bytes_estimate()
        total = weights + cross + kv + acts + transient
        return {"weights": weights, "cross": cross, "kv_cache": kv,
                "activations": acts, "transient": transient, "total": total}

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


# Published per-model alignment heads: the (decoder_layer, head) pairs whose
# cross-attention tracks audio time, used for word-level timestamps
# (pipeline/word_timing.py). Values are the public head sets openai ships
# with each released checkpoint, as the JAX package's config.py transcribes
# them. Unknown or ambiguous models fall back to openai's upper-half-layers
# rule.
ALIGNMENT_HEADS: Dict[str, Tuple[Tuple[int, int], ...]] = {
    "tiny.en": ((1, 0), (2, 0), (2, 5), (3, 0), (3, 1), (3, 2), (3, 3), (3, 4)),
    "tiny": ((2, 2), (3, 0), (3, 2), (3, 3), (3, 4), (3, 5)),
    # base.en: no reliably-reproducible offline record (tests/test_word_timing
    # range-checks every entry against its preset geometry and rejected the
    # candidate set); absent -> upper-half fallback until assets allow
    # transcribing the published config.
    "base": ((3, 1), (4, 2), (4, 3), (4, 7), (5, 1), (5, 2), (5, 4), (5, 6)),
    "small.en": ((6, 6), (7, 0), (7, 3), (7, 8), (8, 2), (8, 5), (8, 7),
                 (9, 0), (9, 4), (9, 8), (9, 10)),
    "small": ((5, 3), (5, 9), (8, 0), (8, 4), (8, 7), (8, 8), (9, 0), (9, 7),
              (9, 9), (10, 5)),
    "medium.en": ((11, 4), (14, 1), (14, 12), (14, 14), (15, 4), (16, 0),
                  (16, 4), (16, 9), (17, 12), (17, 14), (18, 7), (18, 10),
                  (18, 15), (20, 0), (20, 3), (20, 9), (20, 14), (21, 12)),
    "medium": ((13, 15), (15, 4), (15, 15), (16, 1), (20, 0), (23, 4)),
    "large": ((9, 19), (11, 2), (11, 4), (11, 17), (22, 7), (22, 11),
              (22, 17), (23, 2), (23, 15)),  # large-v1
    "large-v2": ((10, 12), (13, 17), (16, 11), (16, 12), (16, 13), (17, 15),
                 (17, 16), (18, 4), (18, 11), (18, 19), (19, 11), (21, 2),
                 (21, 3), (22, 3), (22, 9), (22, 12), (23, 5), (23, 7),
                 (23, 13), (25, 5), (26, 1), (26, 12), (27, 15)),
    "large-v3": ((7, 0), (10, 17), (12, 18), (13, 12), (16, 1), (17, 14),
                 (19, 11), (21, 4), (24, 1), (25, 6)),
    "large-v3-turbo": ((2, 4), (2, 11), (3, 3), (3, 6), (3, 11), (3, 14)),
}


def lookup_alignment_heads(cfg: "WhisperConfig") -> Optional[Tuple[Tuple[int, int], ...]]:
    """The published alignment-head set for the model a GGML header
    describes, or None when the header is ambiguous. The header pins
    (n_audio_layer, n_vocab, n_text_layer): every released model resolves
    uniquely EXCEPT large-v1 vs large-v2 (identical headers) — those
    return None and word timing uses the upper-half-layers fallback rather
    than guess."""
    for name, preset in PRESETS.items():
        if (
            preset.n_audio_layer == cfg.n_audio_layer
            and preset.n_vocab == cfg.n_vocab
            and preset.n_text_layer == cfg.n_text_layer
        ):
            if name == "large" or name == "large-v2":
                if cfg.n_audio_layer == 32 and cfg.n_vocab == 51865:
                    return None  # v1/v2 indistinguishable from the header
            return ALIGNMENT_HEADS.get(name)
    return None


# ---- the serving memory guard: refuse before allocating ----

# The estimate counts the JAX package's terms; the port's device footprint
# (the PyTorch allocator's peak reserved memory) sits above it by the
# allocator's cached blocks and the eager temporaries. The card's readings of
# peak reserved / estimate, each from a process that held only the guarded
# model (chip_smoke.py phase 18, the bench in a subprocess of its own, large-v3
# int8): 1.603 at b64 greedy and 1.307 at b48 beam 5. PEAK_OVER_ESTIMATE is
# the larger one with 6% headroom, and the guard plans against
# CARD_MEMORY_FRACTION of the card's total memory (torch.cuda.mem_get_info),
# so that an admitted configuration's footprint stays within 95% of the card.
PEAK_OVER_ESTIMATE = 1.7
CARD_MEMORY_FRACTION = 0.95 / PEAK_OVER_ESTIMATE


def check_serving_hbm(
    cfg: "WhisperConfig",
    batch: int,
    *,
    beam: int = 1,
    ctx: Optional[int] = None,
    kv_dtype_bytes: int = 2,
    enc_batch: Optional[int] = None,
    engine: bool = False,
    what: str = "serving config",
    budget_bytes: Optional[int] = None,
    device="cuda",
) -> Dict[str, Optional[int]]:
    """Refuse a serving configuration whose estimate
    (:meth:`WhisperConfig.serving_hbm_estimate`) exceeds the budget, with
    :class:`~whisper_tpu_torch.errors.HbmBudgetError`, before anything is
    allocated. The budget is ``budget_bytes`` when given, else
    CARD_MEMORY_FRACTION of the card's total memory when ``device`` is a
    CUDA device (without a card it raises: no default size); on the
    CPU without ``budget_bytes`` nothing is checked. Returns the estimate
    with its ``budget`` (None when unchecked)."""
    from .errors import HbmBudgetError, WhisperError

    est = cfg.serving_hbm_estimate(
        batch=batch, ctx=ctx, kv_dtype_bytes=kv_dtype_bytes, beam=beam,
        enc_batch=enc_batch, engine=engine)
    if budget_bytes is None and str(device).startswith("cuda"):
        import torch

        if not torch.cuda.is_available():  # no default size to fall back on
            raise WhisperError(f"no CUDA card to budget {what} for; pass budget_bytes or "
                               "run on the CPU")
        total = torch.cuda.mem_get_info(torch.device(device))[1]
        budget_bytes = int(total * CARD_MEMORY_FRACTION)
    if budget_bytes is not None and est["total"] > budget_bytes:
        raise HbmBudgetError(what, est, budget_bytes, batch=batch, beam=beam)
    return dict(est, budget=budget_bytes)
