"""The port's SlotEngine (``whisper_tpu_torch.parallel.engine``) on the CPU:
against JAX's SlotEngine on the same micro checkpoint (f32 tokens identical
under all four schedules; int8 pools in token agreement), then the cases of
tests/test_engine.py held port against port (the device loop, the offline
``pipeline.transcribe``, other engines), the constructor's refusals,
``auto_engine``, the engine bench on a tiny model and ``cli batch``."""

import contextlib
import io

import numpy as np
import pytest
import torch

from whisper_tpu.decoding.task import DecodingOptions as JaxOptions
from whisper_tpu.model.load import load_model as jax_load_model
from whisper_tpu.parallel.engine import SlotEngine as JaxEngine
from whisper_tpu_torch import cli
from whisper_tpu_torch.decoding.task import DecodingOptions, decode_full
from whisper_tpu_torch.frontend.mel import frame_count, log_mel_spectrogram, mel_window
from whisper_tpu_torch.io.wav import write_wav
from whisper_tpu_torch.model.load import load_model
from whisper_tpu_torch.parallel.engine import SCHEDULES, SlotEngine
from whisper_tpu_torch.parallel.serving import BatchTranscriber, auto_engine
from whisper_tpu_torch.pipeline.transcribe import TranscribeOptions, transcribe
from whisper_tpu_torch.utils import benchmark

from fixtures import micro_config, synthetic_audio, tiny_config, write_synthetic_ggml


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
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("engine")
    micro, tiny = str(d / "micro.bin"), str(d / "tiny.bin")
    write_synthetic_ggml(micro, micro_config(), seed=9)
    write_synthetic_ggml(tiny, tiny_config(), seed=9)
    return d, micro, tiny


@pytest.fixture(scope="module")
def model(ckpt):
    return load_model(ckpt[1], device="cpu", use_native=False)


@pytest.fixture(scope="module")
def tiny(ckpt):
    return load_model(ckpt[2], device="cpu", use_native=False)


def _audios(n, seed=0):
    rng = np.random.default_rng(seed)
    # different lengths and content: different transcripts
    return [rng.standard_normal(16000 + 4000 * i).astype(np.float32) * 0.3 for i in range(n)]


def _device_loop(model, audio, opts):
    """One stream through the port's fused device loop."""
    mel = log_mel_spectrogram(torch.from_numpy(audio), model.filters, frame_count(len(audio)))
    with torch.inference_mode():
        enc = model.encoder(mel_window(mel, 0, 2 * model.config.n_audio_ctx)[None])
        return decode_full(model.decoder, model.vocab, enc.cross_k, enc.cross_v, opts,
                           use_device_loop=True)[0]


def test_engine_matches_the_jax_engine_under_every_schedule(ckpt, model):
    """f32: the port's engine gives JAX's SlotEngine's tokens (and
    avg_logprob within 1e-4) under all four schedules, with slots reused."""
    audios = _audios(6, seed=5)
    ref = JaxEngine(jax_load_model(ckpt[1], use_native=False), n_slots=2,
                    options=JaxOptions(sample_len=24), chunk_steps=4).transcribe_many(audios)
    for sched in SCHEDULES:
        eng = SlotEngine(model, n_slots=2, options=DecodingOptions(sample_len=24),
                         chunk_steps=4, schedule=sched)
        got = eng.transcribe_many(audios)
        for g, r in zip(got, ref):
            assert g.tokens == r.tokens, sched
            assert abs(g.avg_logprob - r.avg_logprob) < 1e-4
            assert abs(g.no_speech_prob - r.no_speech_prob) < 1e-4
        if sched == "pipelined":
            assert eng.stats["eager_rounds"] == 0
        elif sched == "overlapped":
            assert eng.stats["staged_buckets"] >= 3  # 6 streams, 2 slots
        else:
            assert eng.stats["eager_rounds"] > 0, sched


def test_engine_int8_agrees_with_the_jax_int8_engine(ckpt, model):
    """quantize=True (int8 cross and KV pools, K4 at both sites): token
    agreement with JAX's int8 engine per stream, measured as
    tests/test_quant.py measures it (matches over the shorter length)."""
    audios = _audios(4, seed=3)
    opts = dict(sample_len=16, without_timestamps=True)
    ref = JaxEngine(jax_load_model(ckpt[1], use_native=False), n_slots=2,
                    options=JaxOptions(**opts), chunk_steps=4,
                    quantize=True).transcribe_many(audios)
    eng = SlotEngine(model, n_slots=2, options=DecodingOptions(**opts), chunk_steps=4,
                     quantize=True)
    got = eng.transcribe_many(audios)
    assert eng._cross_pool_k.data.dtype == eng._state.cache_k.data.dtype == torch.int8
    for g, r in zip(got, ref):
        agree = sum(a == b for a, b in zip(g.tokens, r.tokens)) / max(
            min(len(g.tokens), len(r.tokens)), 1)
        assert agree >= 0.9, (g.tokens, r.tokens)


def test_engine_matches_device_loop_with_slot_reuse(model):
    """3 × n_slots streams of different lengths: each stream's tokens are
    the port's device loop's, with slots reused mid-run."""
    opts = DecodingOptions(sample_len=24)
    audios = _audios(6, seed=5)
    eng = SlotEngine(model, n_slots=2, options=opts, chunk_steps=4, schedule="pipelined")
    results = eng.transcribe_many(audios)
    assert len(results) == len(audios) and eng.stats["rounds"] > 3
    for audio, got in zip(audios, results):
        ref = _device_loop(model, audio, opts)
        assert got.tokens == ref.tokens
        assert abs(got.avg_logprob - ref.avg_logprob) < 2e-3


def test_engine_order_and_progress_independence(model):
    """Submission order is kept; a short stream finishing early does not
    perturb a long one sharing the pool (ragged n_past)."""
    opts = DecodingOptions(sample_len=16, without_timestamps=True)
    audios = _audios(4, seed=9)
    results = SlotEngine(model, n_slots=2, options=opts, chunk_steps=2).transcribe_many(audios)
    for audio, got in zip(audios, results):
        alone = SlotEngine(model, n_slots=2, options=opts, chunk_steps=2)
        assert got.tokens == alone.transcribe_many([audio])[0].tokens


def test_engine_partial_bucket_trash_slot(model):
    """5 streams, 3 slots: the first admission puts 3 streams in a bucket of
    4, one entry into the trash row; results are the device loop's and the
    trash row never surfaces."""
    opts = DecodingOptions(sample_len=16)
    audios = _audios(5, seed=9)
    eng = SlotEngine(model, n_slots=3, options=opts, chunk_steps=4)
    results = eng.transcribe_many(audios)
    assert len(results) == 5 and all(r is not None for r in results)
    assert not eng._state.active[-1]
    for audio, res in zip(audios, results):
        assert res.tokens == _device_loop(model, audio, opts).tokens


def test_engine_int16_and_device_audio_equal_f32(model):
    """int16 PCM converts on the device by /32768: the same tokens as its
    f32 conversion; audio already on the device (tensors, the prestaged
    path) gives what host arrays give."""
    opts = DecodingOptions(sample_len=12, without_timestamps=True)
    rng = np.random.default_rng(21)
    i16 = [np.clip(rng.standard_normal(16000 + 5000 * i) * 3000, -32768, 32767).astype(np.int16)
           for i in range(3)]
    f32 = [a.astype(np.float32) / 32768.0 for a in i16]
    run = lambda a: SlotEngine(model, n_slots=2, options=opts,  # noqa: E731
                               chunk_steps=4).transcribe_many(a)
    ref = [r.tokens for r in run(f32)]
    assert [r.tokens for r in run(i16)] == ref
    assert [r.tokens for r in run([torch.from_numpy(a) for a in i16])] == ref


def test_engine_custom_admit_buckets(model):
    audios = _audios(5, seed=9)
    opts = DecodingOptions(sample_len=24)
    ref = SlotEngine(model, n_slots=2, options=opts, chunk_steps=4).transcribe_many(audios)
    eng = SlotEngine(model, n_slots=2, options=opts, chunk_steps=4, admit_buckets=(4, 1))
    assert eng._ADMIT_BUCKETS == (4, 1)
    assert [r.tokens for r in eng.transcribe_many(audios)] == [r.tokens for r in ref]


def test_engine_streams_dont_clobber_option_masks(model):
    """A transcribe_streams call re-derives the rule masks from its
    TranscribeOptions; a later transcribe_many decodes with the
    constructor's masks again."""
    audios = [synthetic_audio(16000 * 6, seed=7), synthetic_audio(16000 * 9, seed=8)]
    opts = DecodingOptions(suppress_tokens=[], suppress_blank=False, without_timestamps=True)
    ref = SlotEngine(model, n_slots=2, options=opts).transcribe_many(audios)
    eng = SlotEngine(model, n_slots=2, options=opts)
    eng.transcribe_streams([synthetic_audio(16000 * 6, seed=1)],
                           TranscribeOptions(temperature=0.0))
    assert [r.tokens for r in eng.transcribe_many(audios)] == [r.tokens for r in ref]


def _same_segments(got, ref, words=False):
    assert got["text"] == ref["text"] and got["language"] == ref["language"]
    assert got["duration"] == ref["duration"]
    assert len(got["segments"]) == len(ref["segments"])
    for gs, rs in zip(got["segments"], ref["segments"]):
        assert gs["tokens"] == rs["tokens"] and gs["seek"] == rs["seek"]
        assert gs["t0"] == rs["t0"] and gs["t1"] == rs["t1"]
        assert gs["no_speech_prob"] == pytest.approx(rs["no_speech_prob"], abs=1e-5)
        assert gs["avg_logprob"] == pytest.approx(rs["avg_logprob"], rel=1e-4, abs=1e-5)
        if words:
            assert gs["words"] == rs["words"]


def test_engine_streams_match_offline_pipeline(tiny):
    """Long-form streams (window continuation, prompt carry, no-speech gate)
    give pipeline.transcribe's segments, window for window; a stream with
    word timestamps gives its words too."""
    audios = [synthetic_audio(16000 * 35, seed=1), synthetic_audio(16000 * 8, seed=3)]
    topts = TranscribeOptions(temperature=0.0, condition_on_previous_text=True)
    eng = SlotEngine(tiny, n_slots=2, chunk_steps=8)
    got = eng.transcribe_streams(audios, topts)
    assert eng.stats["windows"] >= 3
    for g, a in zip(got, audios):
        _same_segments(g, transcribe(tiny, a, topts))
    wopts = TranscribeOptions(temperature=0.0, word_timestamps=True)
    got = SlotEngine(tiny, n_slots=2, chunk_steps=8).transcribe_streams(audios[1:], wopts)[0]
    assert any(s["words"] for s in got["segments"])
    _same_segments(got, transcribe(tiny, audios[1], wopts), words=True)


def test_engine_streams_fallback_escalation(tiny):
    """A gate that always fails at t=0 (logprob_threshold=0) escalates every
    window through decode_full's ladder: the offline pipeline's output."""
    audio = synthetic_audio(16000 * 6, seed=5)
    topts = TranscribeOptions(temperature=(0.0, 0.5, 1.0), logprob_threshold=0.0,
                              no_speech_threshold=None, condition_on_previous_text=True)
    eng = SlotEngine(tiny, n_slots=2, chunk_steps=8)
    got = eng.transcribe_streams([audio], topts)[0]
    ref = transcribe(tiny, audio, topts)
    assert eng.stats["fallbacks"] >= 1
    assert all(s["temperature"] > 0 for s in got["segments"])
    assert got["text"] == ref["text"]
    assert [s["tokens"] for s in got["segments"]] == [s["tokens"] for s in ref["segments"]]


def test_engine_streams_offset_duration_match_offline(tiny):
    audio = synthetic_audio(16000 * 50, seed=2)
    topts = TranscribeOptions(temperature=0.0, offset_ms=15_000, duration_ms=25_000)
    eng = SlotEngine(tiny, n_slots=2, chunk_steps=8)
    _same_segments(eng.transcribe_streams([audio], topts)[0], transcribe(tiny, audio, topts))
    # a clip that ends before it starts has no windows at all
    empty = eng.transcribe_streams([audio], TranscribeOptions(temperature=0.0,
                                                              offset_ms=90_000))[0]
    assert empty["segments"] == []


def test_engine_audio_ctx(model):
    """A per-call audio_ctx the engine was not built with is refused; an
    engine built with a static audio_ctx gives the offline pipeline's
    segments at that audio_ctx, with cross pools of that width."""
    eng = SlotEngine(model, n_slots=2)
    with pytest.raises(ValueError, match="audio_ctx"):
        eng.transcribe_streams([synthetic_audio(16000 * 6, seed=1)],
                               TranscribeOptions(temperature=0.0, audio_ctx=32))
    ctx = 32  # < micro_config's 64
    audio = synthetic_audio(16000 * 4, seed=2)
    topts = TranscribeOptions(temperature=0.0, language="en", audio_ctx=ctx)
    eng = SlotEngine(model, n_slots=2, chunk_steps=4, audio_ctx=ctx)
    got = eng.transcribe_streams([audio], topts)[0]
    assert [s["text"] for s in got["segments"]] == [
        s["text"] for s in transcribe(model, audio, topts)["segments"]]
    assert eng._cross_pool_k.shape[-1] == ctx
    with pytest.raises(ValueError, match="audio_ctx"):
        eng.transcribe_streams([audio], TranscribeOptions(temperature=0.0, audio_ctx=2 * ctx))


def test_engine_warmup_and_int8_word_timing(model):
    """warmup runs every admission bucket size up to n_slots once; an int8
    engine's word timing reads the slot's dequantized cross rows."""
    eng = SlotEngine(model, n_slots=2, chunk_steps=4)
    assert eng.warmup(TranscribeOptions(temperature=0.0), seconds=1) is eng
    assert eng.stats["windows"] == 2  # the last run: both slots at once
    got = SlotEngine(model, n_slots=2, quantize=True, chunk_steps=8).transcribe_streams(
        [synthetic_audio(16000 * 6, seed=3)], TranscribeOptions(temperature=0.0,
                                                                word_timestamps=True))[0]
    words = [w for s in got["segments"] for w in s["words"]]
    assert words and all(0.0 <= w["start"] <= w["end"] <= 6.0 for w in words)


def test_mel_windows_match_the_jax_engines():
    """A bucket's int16 PCM in one mel pass, against JAX's vmapped
    ``_mel_windows``: rows at different gains (their own max), cut to the
    window and padded past a short clip."""
    from whisper_tpu.parallel.engine import _mel_windows as jax_mel_windows
    from whisper_tpu_torch.frontend.mel import mel_filter_bank
    from whisper_tpu_torch.parallel.engine import _mel_windows

    rng = np.random.default_rng(3)
    pcm = (rng.standard_normal((3, 16000)) * np.array([[3000.0], [30.0], [900.0]])).astype(
        np.int16)
    filters = mel_filter_bank(80)
    for n_frames in (64, 128):
        ref = np.asarray(jax_mel_windows(pcm, filters, n_frames))
        ours = _mel_windows(torch.from_numpy(pcm), torch.from_numpy(filters), n_frames).numpy()
        assert ours.shape == ref.shape == (3, 80, n_frames)
        np.testing.assert_allclose(ours, ref, atol=2e-4)  # test_torch_mel.py's bound


def test_engine_refuses_what_it_cannot_take(model):
    with pytest.raises(TypeError):
        SlotEngine(model, use_flash=True)  # the port's encoder always runs K1
    with pytest.raises(ValueError, match="greedy-only"):
        SlotEngine(model, options=DecodingOptions(beam_size=2))
    with pytest.raises(ValueError, match="audio_ctx"):
        SlotEngine(model, audio_ctx=model.config.n_audio_ctx + 1)
    with pytest.raises(ValueError, match="schedule"):
        SlotEngine(model, schedule="bogus")
    with pytest.raises(NotImplementedError, match="item 16"):
        SlotEngine(model, mesh=object())
    with pytest.raises(ValueError, match="greedy-first"):
        SlotEngine(model).transcribe_streams([synthetic_audio(16000, seed=1)],
                                             TranscribeOptions(beam_size=2))
    # the memory guard: the pool with its trash row and a bucket beside it
    # (on the CPU unchecked, the estimate kept)
    eng = SlotEngine(model, n_slots=2, quantize=True)
    assert eng.hbm_estimate == dict(model.config.serving_hbm_estimate(
        batch=3, ctx=eng.pool_ctx, kv_dtype_bytes=1, enc_batch=16, engine=True), budget=None)
    # the pool: prefill bucket + budget + 8 (at most n_text_ctx = 96), the
    # budget trimmed to fit it
    eng = SlotEngine(model, n_slots=2, options=DecodingOptions(sample_len=24))
    assert eng.pool_ctx == 32 + 24 + 8 and eng.max_new == 24
    eng = SlotEngine(model, n_slots=2, max_new_tokens=70)
    assert eng.pool_ctx == 96 and eng.max_new == 96 - 32
    assert "qkv_w" in eng.model.params["decoder"]["blocks"]
    assert "qkv_w" not in model.params["decoder"]["blocks"]  # the caller's model as it was


def test_auto_engine_on_one_device(model):
    eng = auto_engine(model, batch_size=2)
    assert isinstance(eng, BatchTranscriber) and eng.batch_size == 2
    with pytest.raises(NotImplementedError, match="item 16"):
        auto_engine(model, tp=2)


def test_engine_benchmark_json_line_on_a_tiny_model():
    """run_engine_benchmark's line on the CPU (tiny preset, two slots, three
    int16 streams of 24/27/30 s, one timed wave): bench.py's keys, the
    port's metric name, every stream drained."""
    r = benchmark.run_engine_benchmark(model_name="tiny", n_slots=2, n_streams=3,
                                       chunk_steps=16, max_new_tokens=8, seconds=0,
                                       device="cpu")
    assert r["metric"] == "rtf_torch_tiny_engine_s2_q3_int8"
    assert r["value"] > 0 and r["vs_baseline"] is None and r["unit"] == "audio_sec/sec/chip"
    d = r["detail"]
    assert d["waves"] == 1 and d["n_results"] == 3 and d["schedule"] == "overlapped"
    assert set(d["stats"]) >= {"admit_s", "chunk_s", "pull_s", "rounds"}
    assert d["hbm_estimate"]["total"] > 0 and d["peak_allocated_bytes"] is None
    assert benchmark.engine_config_from_env({}) == dict(
        model_name="large-v3", beam_size=None, n_slots=64, n_streams=None, chunk_steps=32, quantize=True,
        seconds=120, prestage=False, enc_int8=False, max_bucket=None, schedule=None)
    assert [len(a) for a in benchmark.engine_streams(4)] == [384000, 432000, 480000, 384000]


def test_cli_batch_prints_the_engines_transcripts(ckpt, model):
    """cli batch (and --long-form) print, per file, what the engine gives on
    the same model."""
    d, micro, _ = ckpt
    wavs = []
    for i, audio in enumerate(_audios(3, seed=4)):
        wavs.append(str(d / f"b{i}.wav"))
        write_wav(wavs[-1], np.clip(audio, -1, 1))
    bf16 = load_model(micro, device="cpu", dtype=torch.bfloat16, use_native=False)
    from whisper_tpu_torch.io.wav import load_wav

    audios = [load_wav(p) for p in wavs]
    many = SlotEngine(bf16, n_slots=2, options=DecodingOptions(without_timestamps=True))
    streams = SlotEngine(bf16, n_slots=2).transcribe_streams(audios[:1], TranscribeOptions())
    for flags, files, expect in (
            ([], wavs, [f"== {p}: {r.text}" for p, r in zip(wavs, many.transcribe_many(audios))]),
            (["--long-form"], wavs[:1], [f"== {wavs[0]}: {streams[0]['text']}"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["batch", micro, *files, "--slots", "2", "--device", "cpu", *flags])
        assert rc == 0
        lines = out.getvalue().strip().splitlines()
        assert lines[:-1] == expect and "realtime, 2 slots" in lines[-1]
