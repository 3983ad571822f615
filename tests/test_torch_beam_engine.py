"""The port's BeamSlotEngine (``whisper_tpu_torch.parallel.beam_engine``) on
the CPU, after tests/test_beam_engine.py: against JAX's BeamSlotEngine on
the same micro checkpoint (f32 tokens identical under all four schedules,
int8 pools in token agreement) and against the port's device beam per
stream, with slots reused; long-form streams against the port's
``pipeline.transcribe`` and JAX's engine streams; the per-group
``beam_update`` against JAX's vmapped ``_bu_group``; the fork copies over a
pool ragged in ``n_past``; the refusals. JAX references are built once per
module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.decoding.task import DecodingOptions as JaxOptions
from whisper_tpu.model.load import load_model as jax_load_model
from whisper_tpu.parallel import beam_engine as jax_beam_engine
from whisper_tpu.pipeline.transcribe import TranscribeOptions as JaxTranscribeOptions
from whisper_tpu_torch.decoding.device_beam import beam_update
from whisper_tpu_torch.decoding.task import DecodingOptions, decode_full
from whisper_tpu_torch.frontend.mel import frame_count, log_mel_spectrogram, mel_window
from whisper_tpu_torch.model.load import load_model
from whisper_tpu_torch.parallel import beam_engine
from whisper_tpu_torch.parallel.beam_engine import BeamSlotEngine
from whisper_tpu_torch.parallel.engine import SCHEDULES
from whisper_tpu_torch.pipeline.transcribe import TranscribeOptions, transcribe

from fixtures import micro_config, synthetic_audio, tiny_config, write_synthetic_ggml

K, SLOTS = 3, 2
OPTS = dict(beam_size=K, sample_len=14)
INT8_OPTS = dict(beam_size=K, sample_len=10, without_timestamps=True)
STREAM_SECONDS = (35, 6)


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
    d = tmp_path_factory.mktemp("beam_engine")
    micro, tiny = str(d / "micro.bin"), str(d / "tiny.bin")
    write_synthetic_ggml(micro, micro_config(), seed=13)
    write_synthetic_ggml(tiny, tiny_config(), seed=9)
    return micro, tiny


@pytest.fixture(scope="module")
def model(ckpt):
    return load_model(ckpt[0], device="cpu", use_native=False)


@pytest.fixture(scope="module")
def tiny(ckpt):
    return load_model(ckpt[1], device="cpu", use_native=False)


def _audios(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(16000 + 4000 * i).astype(np.float32) * 0.3 for i in range(n)]


REUSE_AUDIOS = _audios(3 * SLOTS, seed=7)
INT8_AUDIOS = _audios(3, seed=5)
STREAM_AUDIOS = [synthetic_audio(16000 * s, seed=i + 1) for i, s in enumerate(STREAM_SECONDS)]
STREAM_TOPTS = dict(temperature=0.0, beam_size=2, condition_on_previous_text=True,
                    use_device_loop=True)


@pytest.fixture(scope="module")
def jax_refs(ckpt):
    """JAX's BeamSlotEngine on the same checkpoints, once for the module:
    the slot-reuse run, the int8 run and the long-form streams."""
    micro = jax_load_model(ckpt[0], use_native=False)
    reuse = jax_beam_engine.BeamSlotEngine(micro, n_slots=SLOTS, options=JaxOptions(**OPTS),
                                           chunk_steps=4).transcribe_many(REUSE_AUDIOS)
    int8 = jax_beam_engine.BeamSlotEngine(micro, n_slots=SLOTS, options=JaxOptions(**INT8_OPTS),
                                          chunk_steps=4, quantize=True
                                          ).transcribe_many(INT8_AUDIOS)
    tiny = jax_load_model(ckpt[1], use_native=False)
    streams = jax_beam_engine.BeamSlotEngine(
        tiny, n_slots=SLOTS, chunk_steps=8, options=JaxOptions(beam_size=2)
    ).transcribe_streams(STREAM_AUDIOS, JaxTranscribeOptions(**STREAM_TOPTS))
    return {"reuse": reuse, "int8": int8, "streams": streams}


def _device_beam(model, audio, opts):
    """One stream through the port's device beam (decode_full, device loop)."""
    mel = log_mel_spectrogram(torch.from_numpy(audio), model.filters, frame_count(len(audio)))
    with torch.inference_mode():
        enc = model.encoder(mel_window(mel, 0, 2 * model.config.n_audio_ctx)[None])
        return decode_full(model.decoder, model.vocab, enc.cross_k, enc.cross_v, opts,
                           use_device_loop=True)[0]


@pytest.fixture(scope="module")
def device_beam_refs(model):
    return [_device_beam(model, a, DecodingOptions(**OPTS)) for a in REUSE_AUDIOS]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_slot_reuse_matches_jax_and_the_device_beam(model, jax_refs, device_beam_refs, schedule):
    """3 × n_slots streams of different lengths, group slots reused mid-run:
    each stream's tokens are JAX's BeamSlotEngine's and the port's device
    beam's, avg_logprob within rel 1e-3 / abs 1e-4 and no_speech_prob
    within 1e-5 of both, under every schedule."""
    eng = BeamSlotEngine(model, n_slots=SLOTS, options=DecodingOptions(**OPTS), chunk_steps=4,
                         schedule=schedule)
    got = eng.transcribe_many(REUSE_AUDIOS)
    assert len(got) == len(REUSE_AUDIOS) and eng.stats["rounds"] > 3
    for g, j, d in zip(got, jax_refs["reuse"], device_beam_refs):
        for ref in (j, d):
            assert g.tokens == ref.tokens, (schedule, g.tokens, ref.tokens)
            assert g.avg_logprob == pytest.approx(ref.avg_logprob, rel=1e-3, abs=1e-4)
            assert g.no_speech_prob == pytest.approx(ref.no_speech_prob, abs=1e-5)
    if schedule == "overlapped":
        assert eng.stats["staged_buckets"] >= 2
    stats = eng.fork_stats()
    assert stats["rows"] == (SLOTS + 1) * K and stats["steps"] > 0
    assert 0 < stats["max_forked_rows"] <= stats["forked_rows"]
    # the trash group never forks: at most k - 1 forks in each other group
    assert stats["max_forked_rows"] <= SLOTS * (K - 1)


def test_int8_agrees_with_the_jax_int8_beam_engine(model, jax_refs):
    """quantize=True (int8 cross and KV pools, K4 at both sites, K7 over the
    four int8 leaves): token agreement with JAX's int8 beam engine per
    stream, measured as tests/test_quant.py measures it."""
    eng = BeamSlotEngine(model, n_slots=SLOTS, options=DecodingOptions(**INT8_OPTS),
                         chunk_steps=4, quantize=True)
    got = eng.transcribe_many(INT8_AUDIOS)
    assert eng._cross_pool_k.data.dtype == eng._state.cache_k.data.dtype == torch.int8
    for g, r in zip(got, jax_refs["int8"]):
        agree = sum(a == b for a, b in zip(g.tokens, r.tokens)) / max(
            min(len(g.tokens), len(r.tokens)), 1)
        assert agree > 0.6, (g.tokens, r.tokens)


def test_streams_match_the_offline_pipeline_and_jax(tiny, jax_refs):
    """Long-form beam streams (window continuation with prompt carry over
    beam groups): the segments of the port's pipeline.transcribe with the
    same beam on the device beam, window for window, and JAX's engine's."""
    topts = TranscribeOptions(**STREAM_TOPTS)
    eng = BeamSlotEngine(tiny, n_slots=SLOTS, chunk_steps=8, options=DecodingOptions(beam_size=2))
    got = eng.transcribe_streams(STREAM_AUDIOS, topts)
    assert eng.stats["windows"] > len(STREAM_AUDIOS)  # a stream of several windows ran
    for g, a, j in zip(got, STREAM_AUDIOS, jax_refs["streams"]):
        for ref in (transcribe(tiny, a, topts), j):
            assert (g["language"], g["duration"], g["text"]) == (
                ref["language"], ref["duration"], ref["text"])
            assert len(g["segments"]) == len(ref["segments"])
            for gs, rs in zip(g["segments"], ref["segments"]):
                assert gs["tokens"] == rs["tokens"] and gs["seek"] == rs["seek"]
                assert gs["t0"] == rs["t0"] and gs["t1"] == rs["t1"]
                assert gs["no_speech_prob"] == pytest.approx(rs["no_speech_prob"], abs=1e-5)
                assert gs["avg_logprob"] == pytest.approx(rs["avg_logprob"], rel=1e-4,
                                                          abs=1e-5)


def test_per_group_beam_update_matches_jax_bu_group():
    """beam_update with a (G,) step against JAX's vmapped one-group
    ``_bu_group`` on seeded inputs: groups at different steps, one of them
    frozen at the history's length (JAX's dynamic_update_slice clamps the
    write into the last column, and so does the port), with finished sets
    part full. A (G,) step of one value gives what the int step gives."""
    rng = np.random.default_rng(11)
    G, k, SL, eot = 4, 3, 6, 7
    top_lp = np.sort(rng.standard_normal((G * k, k + 1)).astype(np.float32), axis=1)[:, ::-1]
    top_ids = rng.integers(0, 9, (G * k, k + 1)).astype(np.int64)
    top_ids[::2, 0] = eot  # EOT candidates in front
    sum_lp = rng.standard_normal((G, k)).astype(np.float32)
    tokens = rng.integers(0, 9, (G, k, SL)).astype(np.int64)
    fin_t = rng.integers(0, 9, (G, k, SL)).astype(np.int64)
    fin_s = rng.standard_normal((G, k)).astype(np.float32)
    fin_l = rng.integers(0, SL, (G, k)).astype(np.int64)
    fin_c = np.array([0, 1, 2, 0], np.int64)
    step = np.array([0, 3, SL - 1, SL], np.int32)  # the last group frozen past its end
    args = (top_lp, top_ids, sum_lp, tokens, fin_t, fin_s, fin_l, fin_c)

    want = jax.vmap(jax_beam_engine._bu_group, in_axes=(0,) * 9 + (None, None))(
        *(jnp.asarray(a.reshape((G, k) + a.shape[1:]) if i < 2 else a)
          for i, a in enumerate(args)), jnp.asarray(step), k, eot)
    got = beam_update(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
                      torch.from_numpy(step), k, eot)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(g.shape))
    # the frozen group's history: its parents', the last column overwritten
    want_frozen = tokens[3][got[2][3].numpy()]
    want_frozen[:, -1] = got[1][3].numpy()
    np.testing.assert_array_equal(got[3][3].numpy(), want_frozen)
    for s in range(SL):
        per_group = beam_update(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
                                torch.full((G,), s, dtype=torch.int32), k, eot)
        scalar = beam_update(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
                             s, k, eot)
        for a, b in zip(per_group, scalar):
            assert torch.equal(a, b)


def test_fork_copies_over_a_ragged_pool(model, monkeypatch):
    """K7 copies whole rows: on a pool whose groups sit at different
    n_past, every forked row holds its source row over every column after
    the copy, identity rows are untouched, and the result is the device
    beam's."""
    seen = {"calls": 0, "forked": 0, "ragged": 0}
    real = beam_engine.cow_copy_rows

    def checked(leaves, src):
        before = [a.clone() for a in leaves]
        out = real(leaves, src)
        rows = torch.arange(src.shape[0])
        dst = rows[src != rows]
        for a, b in zip(leaves, before):
            assert torch.equal(a[dst], b[src[dst]])
            assert torch.equal(a[src == rows], b[src == rows])
        seen["calls"] += 1
        seen["forked"] += dst.numel()
        return out

    real_decode = beam_engine.decode_step

    def decode_spy(decoder, tokens, n_past, *rest):
        if isinstance(n_past, torch.Tensor):  # the chunk's steps, not the prefill
            seen["ragged"] += int(n_past.unique().numel() > 1)
        return real_decode(decoder, tokens, n_past, *rest)

    monkeypatch.setattr(beam_engine, "cow_copy_rows", checked)
    monkeypatch.setattr(beam_engine, "decode_step", decode_spy)
    opts = DecodingOptions(**OPTS)
    audios = REUSE_AUDIOS[:4]
    got = BeamSlotEngine(model, n_slots=SLOTS, options=opts, chunk_steps=3,
                         schedule="pipelined").transcribe_many(audios)
    assert seen["forked"] > 0 and seen["ragged"] > 0
    for g, a in zip(got, audios):
        assert g.tokens == _device_beam(model, a, opts).tokens


def test_refuses_invalid_options(model):
    with pytest.raises(ValueError, match="beam_size >= 2"):
        BeamSlotEngine(model, options=DecodingOptions(beam_size=None))
    with pytest.raises(ValueError, match="patience"):
        BeamSlotEngine(model, options=DecodingOptions(beam_size=3, patience=2.0))
    with pytest.raises(NotImplementedError, match="item 16"):
        BeamSlotEngine(model, options=DecodingOptions(beam_size=3), mesh=object())
    with pytest.raises(ValueError, match="audio_ctx"):
        BeamSlotEngine(model, options=DecodingOptions(beam_size=3),
                       audio_ctx=model.config.n_audio_ctx + 1)
    # the memory guard counts k rows a slot and names the class
    eng = BeamSlotEngine(model, n_slots=2, options=DecodingOptions(beam_size=3), quantize=True)
    assert eng.hbm_estimate == dict(model.config.serving_hbm_estimate(
        batch=3, beam=3, ctx=eng.pool_ctx, kv_dtype_bytes=1, enc_batch=16, engine=True),
        budget=None)


def test_streams_refuse_a_mismatched_beam(model):
    eng = BeamSlotEngine(model, n_slots=2, options=DecodingOptions(beam_size=3))
    for bad in (TranscribeOptions(beam_size=5), TranscribeOptions(beam_size=None),
                TranscribeOptions(beam_size=3, patience=1.5),
                TranscribeOptions(beam_size=3, audio_ctx=32)):
        with pytest.raises(ValueError):
            eng.transcribe_streams([_audios(1)[0]], bad)


def test_warmup_decodes_at_the_beam_width(model):
    """warmup without options runs TranscribeOptions(beam_size=k): every
    admission bucket size up to n_slots, the last with both groups."""
    eng = BeamSlotEngine(model, n_slots=2, options=DecodingOptions(beam_size=2), chunk_steps=4)
    assert eng.warmup(seconds=1) is eng
    assert eng.stats["windows"] == 2
