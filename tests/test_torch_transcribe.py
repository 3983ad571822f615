"""whisper_full, port vs JAX at f32 on the CPU: ``transcribe`` over one and
several windows, with the options that change the loop, on the tiny
synthetic checkpoint of tests/test_transcribe.py.

Tolerances: text, language, duration and every segment's tokens, seek, t0,
t1 (and word times where asked) identical; avg_logprob and no_speech_prob
within 1e-4 (f32 sums in another order; the port's decoder logits are held
to JAX within 3e-4). Sampling cannot match ``jax.random``, so the ladder at
t > 0 is held to JAX in structure: the rungs taken, in order, with the
options each passes, and the result's fields.
"""

import dataclasses

import numpy as np
import pytest

from whisper_tpu.decoding.result import DecodingResult as JaxResult
from whisper_tpu.model.load import load_model as jax_load_model
from whisper_tpu.pipeline import transcribe as jax_transcribe_module
from whisper_tpu_torch.config import SAMPLE_RATE
from whisper_tpu_torch.decoding.result import DecodingResult
from whisper_tpu_torch.model.load import load_model
from whisper_tpu_torch.pipeline import transcribe as transcribe_module
from whisper_tpu_torch.pipeline.transcribe import TranscribeOptions, gate_needs_fallback, transcribe

from fixtures import synthetic_audio, tiny_config, write_synthetic_ggml


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "ggml-tiny-synth.bin")
    write_synthetic_ggml(path, tiny_config(), seed=9)
    return jax_load_model(path, use_native=False), load_model(path, device="cpu")


def _assert_same_transcript(got: dict, want: dict, words: bool = False) -> None:
    assert got["text"] == want["text"]
    assert got["language"] == want["language"]
    assert got["duration"] == want["duration"]
    assert len(got["segments"]) == len(want["segments"])
    for g, w in zip(got["segments"], want["segments"]):
        for key in ("id", "seek", "t0", "t1", "text", "tokens", "temperature"):
            assert g[key] == w[key], key
        assert abs(g["avg_logprob"] - w["avg_logprob"]) < 1e-4
        assert abs(g["no_speech_prob"] - w["no_speech_prob"]) < 1e-4
        if words:
            assert g["words"] == w["words"]
        if w["token_data"] is not None:
            assert g["token_data"] == w["token_data"]


CASES = {  # name: (seconds of audio, TranscribeOptions fields)
    "8s": (8, dict(condition_on_previous_text=False)),
    "35s-previous-text": (35, dict(condition_on_previous_text=True)),
    "without-timestamps": (6, dict(without_timestamps=True, condition_on_previous_text=False)),
    "offset-duration": (35, dict(offset_ms=3000, duration_ms=20000)),
    "audio-ctx-auto": (35, dict(audio_ctx="auto")),
    "initial-prompt": (8, dict(initial_prompt="<t5><t17> hello", condition_on_previous_text=True)),
    "token-timestamps": (8, dict(token_timestamps=True, condition_on_previous_text=False)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_transcribe_matches_jax(models, name):
    jax_model, model = models
    seconds, fields = CASES[name]
    audio = synthetic_audio(SAMPLE_RATE * seconds)
    want = jax_transcribe_module.transcribe(
        jax_model, audio, jax_transcribe_module.TranscribeOptions(temperature=0.0, **fields))
    got = transcribe(model, audio, TranscribeOptions(temperature=0.0, **fields))
    _assert_same_transcript(got, want)
    assert got["segments"], "expected at least one segment"
    if name in ("35s-previous-text", "audio-ctx-auto"):
        assert len({s["seek"] for s in got["segments"]}) >= 2, "expected two windows"


def test_transcribe_reads_wav_and_word_timestamps_match_jax(models, tmp_path):
    """A WAV path through both packages' load_wav, with word timestamps."""
    from whisper_tpu_torch.io.wav import write_wav

    jax_model, model = models
    path = str(tmp_path / "clip.wav")
    write_wav(path, synthetic_audio(SAMPLE_RATE * 8))
    fields = dict(temperature=0.0, word_timestamps=True, condition_on_previous_text=False)
    want = jax_transcribe_module.transcribe(
        jax_model, path, jax_transcribe_module.TranscribeOptions(**fields))
    got = transcribe(model, path, **fields)
    _assert_same_transcript(got, want, words=True)
    assert any(s["words"] for s in got["segments"])
    assert model.timers.counts.get("word_align", 0) >= 1


def test_gate_needs_fallback_matches_jax():
    grid = [(ratio, lp, nosp) for ratio in (1.0, 2.4, 3.0) for lp in (-2.0, -1.0, -0.5)
            for nosp in (0.1, 0.6, 0.9)]
    thresholds = [dict(), dict(compression_ratio_threshold=None),
                  dict(logprob_threshold=None), dict(no_speech_threshold=None)]
    for ratio, lp, nosp in grid:
        fields = dict(tokens=[1], text="x", avg_logprob=lp, no_speech_prob=nosp,
                      temperature=0.0, compression_ratio=ratio)
        for th in thresholds:
            assert gate_needs_fallback(DecodingResult(**fields), TranscribeOptions(**th)) == \
                jax_transcribe_module.gate_needs_fallback(
                    JaxResult(**fields), jax_transcribe_module.TranscribeOptions(**th))


def _rung_spy(module, monkeypatch):
    """Record the options of every decode_full call the ladder makes."""
    rungs, real = [], module.decode_full

    def spy(*args, **kwargs):
        options = args[5] if len(args) > 5 else args[4]
        rungs.append((options.temperature, options.beam_size, options.best_of, options.patience))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "decode_full", spy)
    return rungs


def test_ladder_structure_matches_jax(models, monkeypatch):
    """A gate that always fires (every avg_logprob < 0) runs every rung: beam
    (with patience) at t = 0 only, best_of at t > 0 only, in ladder order;
    the result carries the last rung's temperature."""
    jax_model, model = models
    audio = synthetic_audio(SAMPLE_RATE * 4)
    fields = dict(temperature=(0.0, 0.5), beam_size=2, patience=1.0, best_of=2,
                  logprob_threshold=0.0, no_speech_threshold=None,
                  condition_on_previous_text=False)
    jax_rungs = _rung_spy(jax_transcribe_module, monkeypatch)
    want = jax_transcribe_module.transcribe(
        jax_model, audio, jax_transcribe_module.TranscribeOptions(**fields))
    rungs = _rung_spy(transcribe_module, monkeypatch)
    got = transcribe(model, audio, TranscribeOptions(**fields))
    assert rungs == jax_rungs
    assert rungs[:2] == [(0.0, 2, None, 1.0), (0.5, None, 2, None)]
    assert len(rungs) == 2 * len({s["seek"] for s in got["segments"]})
    assert got.keys() == want.keys()
    assert all(s.keys() == want["segments"][0].keys() for s in got["segments"])
    for seg in got["segments"]:
        assert seg["temperature"] == 0.5
        assert np.isfinite(seg["avg_logprob"]) and 0.0 <= seg["no_speech_prob"] <= 1.0
        assert all(0 <= t < model.config.n_vocab for t in seg["tokens"])


def test_transcribe_options_fields_match_jax():
    """Every JAX option but the speculative draft's block size (the port has
    no draft model yet) has its counterpart, with the same default."""
    ours = {f.name: f.default for f in dataclasses.fields(TranscribeOptions)}
    ref = {f.name: f.default for f in dataclasses.fields(jax_transcribe_module.TranscribeOptions)}
    assert set(ref) - set(ours) == {"speculative_gamma"}
    assert set(ours) <= set(ref)
    for name, value in ours.items():
        assert value == ref[name], name
