"""Chunk-parallel long-form transcription, port vs JAX at f32 on the CPU
(after tests/test_chunked.py): ``transcribe_chunked`` on one synthetic
checkpoint loaded by both packages, disjoint and overlapped windows, one
batch and several; the overlap midpoint rule of ``merge_window_segments``
against JAX's on the same segment lists; the trailing-timestamp case of
``extract_segments``; and a device mesh refused.

Tolerances: text, language, duration and every segment's id, seek, text and
tokens identical; t0 and t1 within 1e-6 s (both are token counts times
0.02 s); avg_logprob and no_speech_prob within 1e-4 (f32 sums in another
order).
"""

import dataclasses

import pytest
import torch

from whisper_tpu.decoding.result import DecodingResult as JaxResult
from whisper_tpu.decoding.result import Segment as JaxSegment
from whisper_tpu.model.load import load_model as jax_load_model
from whisper_tpu.pipeline import chunked as jax_chunked
from whisper_tpu.pipeline.transcribe import TranscribeOptions as JaxOptions
from whisper_tpu_torch.config import SAMPLE_RATE
from whisper_tpu_torch.decoding.result import DecodingResult, Segment
from whisper_tpu_torch.model.load import load_model
from whisper_tpu_torch.pipeline.chunked import (extract_segments, merge_window_segments,
                                                transcribe_chunked)
from whisper_tpu_torch.pipeline.transcribe import TranscribeOptions

from fixtures import synthetic_audio, tiny_config, write_synthetic_ggml


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
def models(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "ggml-tiny-synth.bin")
    write_synthetic_ggml(path, tiny_config(), seed=9)
    return jax_load_model(path, use_native=False), load_model(path, device="cpu")


def assert_same_chunked(got: dict, want: dict) -> None:
    for key in ("text", "language", "duration"):
        assert got[key] == want[key], key
    assert len(got["segments"]) == len(want["segments"])
    for g, w in zip(got["segments"], want["segments"]):
        for key in ("id", "seek", "text", "tokens", "temperature"):
            assert g[key] == w[key], key
        for key in ("t0", "t1"):
            assert abs(g[key] - w[key]) <= 1e-6, key
        for key in ("avg_logprob", "no_speech_prob"):
            assert abs(g[key] - w[key]) < 1e-4, key


CASES = {  # name: (seconds of audio, overlap seconds, windows per batch)
    "disjoint": (40, 0.0, 4),
    "overlap": (40, 5.0, 4),
    "one-window-batches": (40, 0.0, 1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_transcribe_chunked_matches_jax(models, name):
    jax_model, model = models
    seconds, overlap, batch_windows = CASES[name]
    audio = synthetic_audio(SAMPLE_RATE * seconds)
    want = jax_chunked.transcribe_chunked(
        jax_model, audio, JaxOptions(condition_on_previous_text=False),
        batch_windows=batch_windows, overlap_seconds=overlap)
    got = transcribe_chunked(model, audio, TranscribeOptions(condition_on_previous_text=False),
                             batch_windows=batch_windows, overlap_seconds=overlap)
    assert_same_chunked(got, want)
    assert len({s["seek"] for s in got["segments"]}) >= 2, "expected two windows"
    mids = [(s["t0"] + s["t1"]) / 2 for s in got["segments"]]
    assert mids == sorted(mids)
    assert model.timers.counts["encode"] >= 1 and model.timers.counts["decode"] >= 1


def _segments(cls, spans):
    return [cls(id=0, seek=0, t0=t0, t1=t1, text=text, tokens=[], avg_logprob=0.0,
                no_speech_prob=0.0, temperature=0.0, compression_ratio=1.0)
            for t0, t1, text in spans]


def test_merge_window_segments_overlap_midpoint_rule():
    """Windows at frames 0 and 2500 (25 s) with 500 frames (5 s) of
    overlap: the cut is at 27.5 s. Each segment is kept by exactly one
    window, as JAX's merge keeps it."""
    w0 = [(0.0, 10.0, " a"), (10.0, 26.0, " b"), (26.5, 29.9, " clip")]
    w1 = [(25.2, 27.0, " dup-b-tail"), (27.2, 31.0, " c"), (31.0, 40.0, " d")]
    merged = merge_window_segments([(0, _segments(Segment, w0)), (2500, _segments(Segment, w1))],
                                   overlap_frames=500)
    want = jax_chunked.merge_window_segments(
        [(0, _segments(JaxSegment, w0)), (2500, _segments(JaxSegment, w1))], overlap_frames=500)
    assert [s.text for s in merged] == [" a", " b", " c", " d"] == [s.text for s in want]
    assert [s.id for s in merged] == [0, 1, 2, 3]
    # disjoint windows at 0 and 30 s: the cut is at 30 s
    got = merge_window_segments([(0, _segments(Segment, w0)), (3000, _segments(Segment, w1))], 0)
    want = jax_chunked.merge_window_segments(
        [(0, _segments(JaxSegment, w0)), (3000, _segments(JaxSegment, w1))], 0)
    assert [(s.id, s.text) for s in got] == [(s.id, s.text) for s in want]
    assert [s.text for s in got] == [" a", " b", " clip", " d"]


@pytest.mark.parametrize("tokens", [
    [0, 7, 10, 10, 8, 20],      # a trailing single timestamp closes the last segment
    [0, 7, 10, 10, 8, 9],       # an unterminated tail runs to the window end
    [7, 8, 15],                 # no consecutive pair: one segment
    [],
], ids=["single-timestamp-ending", "unterminated-tail", "no-pair", "empty"])
def test_extract_segments_matches_jax(models, tokens):
    """Timestamp offsets from token_beg, through both packages' grammar."""
    jax_model, model = models
    beg = model.vocab.token_beg
    toks = [beg + t if t in (0, 10, 15, 20) else t for t in tokens]
    fields = dict(tokens=toks, text="", avg_logprob=-0.1, no_speech_prob=0.0, temperature=0.0,
                  compression_ratio=1.0)
    got = extract_segments(DecodingResult(**fields), model.vocab, time_offset=30.0,
                           window_duration=30.0, seek=3000)
    want = jax_chunked.extract_segments(JaxResult(**fields), jax_model.vocab, time_offset=30.0,
                                        window_duration=30.0, seek=3000)
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]
    if tokens and tokens[-1] == 20:
        assert got[-1].t1 == pytest.approx(30.0 + 20 * 0.02)  # not the window end


def test_transcribe_chunked_refuses_a_mesh(models):
    _, model = models
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        transcribe_chunked(model, synthetic_audio(SAMPLE_RATE), mesh=object())
