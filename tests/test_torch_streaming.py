"""Streaming transcription in the port: the three cases of
tests/test_streaming.py against the port (incremental feeds whose final
transcript equals offline ``transcribe``, the normalization-drift fallback,
finalize's idempotence), and the port's finalized transcript equal to the
JAX package's ``StreamingTranscriber`` fed the same increments, on the same
random weights (JAX's numpy draws) at f32 on the CPU.

Every case decodes at temperature 0 only: the ladder's sampling rungs cannot
match ``jax.random`` (tests/test_torch_transcribe.py holds the ladder to JAX
in structure), and one rung keeps the case within the test budget.
Tolerances: text and every segment's tokens, t0 and t1 identical.
"""

import numpy as np
import pytest
import torch

from whisper_tpu.model.load import random_model as jax_random_model
from whisper_tpu.pipeline.streaming import StreamingTranscriber as JaxStreamingTranscriber
from whisper_tpu.pipeline.transcribe import TranscribeOptions as JaxOptions
from whisper_tpu_torch.config import SAMPLE_RATE
from whisper_tpu_torch.model.load import random_model
from whisper_tpu_torch.pipeline.streaming import StreamingTranscriber
from whisper_tpu_torch.pipeline.transcribe import TranscribeOptions, transcribe

from fixtures import synthetic_audio, tiny_config


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads for this module's torch work: the suite runs in
    several worker processes at once, and torch's default of one thread a
    core in each of them oversubscribes the cores (its spinning thread pool
    then slows these decode loops tens of times)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return (jax_random_model(tiny_config(), seed=13, on_device=False),
            random_model(tiny_config(), seed=13, device="cpu", on_device=False))


def _loud_onset_audio(seconds):
    """Loudest frame early: the global mel max is known from the start, so
    streaming commits are decoded against the offline normalization."""
    audio = synthetic_audio(SAMPLE_RATE * seconds) * 0.2
    audio[: SAMPLE_RATE // 2] *= 5.0
    return audio.astype(np.float32)


def _same_segments(a: dict, b: dict) -> None:
    assert a["text"] == b["text"]
    assert len(a["segments"]) == len(b["segments"])
    for x, y in zip(a["segments"], b["segments"]):
        assert x["tokens"] == y["tokens"]
        assert x["t0"] == y["t0"] and x["t1"] == y["t1"]


def test_streaming_matches_offline_and_jax_5s_increments(models):
    jax_model, model = models
    audio = _loud_onset_audio(70)
    offline = transcribe(model, audio, TranscribeOptions(temperature=0.0))

    st = StreamingTranscriber(model, TranscribeOptions(temperature=0.0))
    jst = JaxStreamingTranscriber(jax_model, JaxOptions(temperature=0.0), draft=False)
    committed, drafts = [], 0
    for start in range(0, len(audio), 5 * SAMPLE_RATE):
        out = st.feed(audio[start: start + 5 * SAMPLE_RATE])
        jst.feed(audio[start: start + 5 * SAMPLE_RATE])
        committed.extend(out["committed"])
        drafts += bool(out["draft"])
    final = st.finalize()

    _same_segments(final, offline)
    _same_segments(final, jst.finalize())
    # windows were committed before finalize (true streaming, not buffering)
    assert committed, "no segments committed during feeding"
    assert all(c["tokens"] == s["tokens"] for c, s in zip(committed, final["segments"]))
    assert drafts > 0


def test_streaming_normalization_drift_fallback(models):
    """A loud late section changes the global mel max after windows were
    committed; finalize() must detect the drift and still return the exact
    offline transcript."""
    _, model = models
    audio = synthetic_audio(SAMPLE_RATE * 70) * 0.05
    audio[-SAMPLE_RATE:] *= 40.0  # loudest frame at the very end
    audio = audio.astype(np.float32)
    offline = transcribe(model, audio, TranscribeOptions(temperature=0.0))

    st = StreamingTranscriber(model, TranscribeOptions(temperature=0.0))
    committed = []
    for start in range(0, len(audio), 10 * SAMPLE_RATE):
        committed += st.feed(audio[start: start + 10 * SAMPLE_RATE])["committed"]
    assert committed, "the drift case needs a window committed before the loud end"
    _same_segments(st.finalize(), offline)


def test_streaming_finalize_idempotent_and_feed_after_final(models):
    _, model = models
    audio = _loud_onset_audio(5)
    st = StreamingTranscriber(model, TranscribeOptions(temperature=0.0))
    st.feed(audio)
    a = st.finalize()
    assert st.finalize() is a
    with pytest.raises(RuntimeError):
        st.feed(audio)


def test_streaming_refuses_what_it_cannot_know(models):
    """Language detection, audio_ctx "auto" and a clip range need the whole
    audio: the port refuses them as JAX's does."""
    _, model = models
    multilingual = random_model(tiny_config(n_vocab=51865), seed=1, device="cpu",
                                on_device=False)
    with pytest.raises(ValueError, match="language"):
        StreamingTranscriber(multilingual, TranscribeOptions())
    with pytest.raises(ValueError, match="audio_ctx"):
        StreamingTranscriber(model, TranscribeOptions(audio_ctx="auto"))
    with pytest.raises(ValueError, match="offset_ms"):
        StreamingTranscriber(model, TranscribeOptions(offset_ms=1000))
