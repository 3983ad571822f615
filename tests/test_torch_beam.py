"""Beam search, port vs JAX at f32 on the CPU (micro fixtures).

Both routes of ``decode_full`` (the host loop with K6's plain reorder, and
the device beam with K7's plain fork copy), the bookkeeping functions under
fuzz, group-shared cross memory in ``decode_step``, ``BatchTranscriber``
with beam options and the int8 ``make_serving_step(beam_size=3)``.
Tolerances: tokens identical; avg_logprob within 1e-3 and no_speech_prob
within 1e-4 (f32 sums in another order, the bounds JAX's own
tests/test_topk_beam.py holds its two routes to); logits within 3e-4 (the
port's f32 bound against JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.decoding import device_beam as jax_beam
from whisper_tpu.decoding.task import DecodingOptions as JaxOptions
from whisper_tpu.decoding.task import decode_full as jax_decode_full
from whisper_tpu.io.vocab import make_vocab as jax_make_vocab
from whisper_tpu.model import quant as jq
from whisper_tpu.model.encoder import encode as jax_encode
from whisper_tpu.model.load import load_model as jax_load_model
from whisper_tpu.model.params import params_from_ggml as jax_params_from_ggml
from whisper_tpu.parallel.serving import BatchTranscriber as JaxTranscriber
from whisper_tpu.utils.benchmark import make_serving_step as jax_make_serving_step
from whisper_tpu_torch.decoding import device_beam
from whisper_tpu_torch.decoding.sequence import BeamSearchDecoder
from whisper_tpu_torch.decoding.task import DecodingOptions, DecodingTask, decode_full
from whisper_tpu_torch.io.vocab import make_vocab
from whisper_tpu_torch.kernels import beam_gather
from whisper_tpu_torch.model import quant as tq
from whisper_tpu_torch.model.decoder import TextDecoder, decode_step, init_cache
from whisper_tpu_torch.model.load import load_model
from whisper_tpu_torch.model.params import params_from_ggml, params_to_torch
from whisper_tpu_torch.parallel.serving import BatchTranscriber
from whisper_tpu_torch.utils.benchmark import make_serving_step, prepare_serving_params

from fixtures import (micro_config, random_tensors, synthetic_audio, synthetic_tokens,
                      write_synthetic_ggml)


@pytest.fixture(scope="module")
def setup():
    """Two encoded windows of one micro model, in both packages."""
    cfg = micro_config(n_vocab=51864)
    tensors = random_tensors(cfg, seed=31)
    jparams = jax.tree.map(jnp.asarray, jax_params_from_ggml(tensors, cfg))
    tokens = synthetic_tokens(cfg.n_vocab)
    mel = np.random.default_rng(5).standard_normal(
        (2, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    enc = jax_encode(jparams, jnp.asarray(mel), cfg)
    decoder = TextDecoder(params_to_torch(params_from_ggml(tensors, cfg), "cpu", torch.float32),
                          cfg)
    cross = tuple(torch.from_numpy(np.array(a)) for a in (enc.cross_k, enc.cross_v))
    return (cfg, jparams, jax_make_vocab(cfg.n_vocab, tokens, cfg.n_vocab), enc, decoder,
            make_vocab(cfg.n_vocab, tokens, cfg.n_vocab), cross)


def _assert_results_match(out, ref):
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.tokens == r.tokens and o.text == r.text
        assert abs(o.avg_logprob - r.avg_logprob) < 1e-3
        assert abs(o.no_speech_prob - r.no_speech_prob) < 1e-4


@pytest.mark.parametrize("device_loop", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("without_timestamps", [True, False])
def test_beam_matches_jax(setup, device_loop, without_timestamps):
    cfg, jparams, jvocab, enc, decoder, vocab, (ck, cv) = setup
    kw = dict(beam_size=3, sample_len=14, without_timestamps=without_timestamps)
    ref = jax_decode_full(jparams, cfg, jvocab, enc.cross_k, enc.cross_v, JaxOptions(**kw),
                          use_device_loop=device_loop)
    out = decode_full(decoder, vocab, ck, cv, DecodingOptions(**kw), use_device_loop=device_loop)
    _assert_results_match(out, ref)


@pytest.mark.parametrize("device_loop", [False, True], ids=["host", "device"])
def test_beam_with_prompt_matches_jax(setup, device_loop):
    """A 40-token prompt: sot_index > 0 and a 64-token prefill bucket."""
    cfg, jparams, jvocab, enc, decoder, vocab, (ck, cv) = setup
    kw = dict(beam_size=3, sample_len=10, prompt=list(range(300, 340)))
    ref = jax_decode_full(jparams, cfg, jvocab, enc.cross_k, enc.cross_v, JaxOptions(**kw),
                          use_device_loop=device_loop)
    out = decode_full(decoder, vocab, ck, cv, DecodingOptions(**kw), use_device_loop=device_loop)
    _assert_results_match(out, ref)


def test_host_greedy_matches_jax(setup):
    """The host loop with the greedy decoder (use_device_loop=False)."""
    cfg, jparams, jvocab, enc, decoder, vocab, (ck, cv) = setup
    kw = dict(sample_len=12, without_timestamps=False)
    ref = jax_decode_full(jparams, cfg, jvocab, enc.cross_k, enc.cross_v, JaxOptions(**kw))
    out = decode_full(decoder, vocab, ck, cv, DecodingOptions(**kw), use_device_loop=False)
    _assert_results_match(out, ref)
    device = decode_full(decoder, vocab, ck, cv, DecodingOptions(**kw), use_device_loop=True)
    assert [r.tokens for r in device] == [r.tokens for r in out]


def test_host_beam_reorders_with_k6_only_when_sources_move(setup, monkeypatch):
    cfg, _, _, _, decoder, vocab, (ck, cv) = setup
    calls = []
    real = beam_gather.permute_cache_rows

    def spy(cache, rows):
        calls.append(rows.clone())
        return real(cache, rows)

    real_update, moved = BeamSearchDecoder.update, []

    def update_spy(self, *args):
        out = real_update(self, *args)
        moved.append(not np.array_equal(out[2], np.arange(len(out[2]))))
        return out

    monkeypatch.setattr("whisper_tpu_torch.decoding.task.permute_cache_rows", spy)
    monkeypatch.setattr(BeamSearchDecoder, "update", update_spy)
    decode_full(decoder, vocab, ck, cv, DecodingOptions(beam_size=3, sample_len=8),
                use_device_loop=False)
    assert calls and len(calls) == sum(moved)  # one reorder per step whose sources moved
    for rows in calls:
        assert not torch.equal(rows, torch.arange(rows.shape[0]))


def test_device_beam_fork_copies_once_a_step(setup, monkeypatch):
    """The device beam calls cow_copy_rows on every leaf of its cache once
    before each decode-step forward, with no host-side skip; some steps
    fork."""
    cfg, _, _, _, decoder, vocab, (ck, cv) = setup
    copies, forwards = [], []
    real_copy, real_step = device_beam.cow_copy_rows, device_beam.decode_step

    def copy_spy(leaves, src):
        copies.append((len(leaves), src.clone()))
        return real_copy(leaves, src)

    def step_spy(*args):
        forwards.append(args[1].shape[1])
        return real_step(*args)

    monkeypatch.setattr(device_beam, "cow_copy_rows", copy_spy)
    monkeypatch.setattr(device_beam, "decode_step", step_spy)
    decode_full(decoder, vocab, ck, cv, DecodingOptions(beam_size=3, sample_len=10),
                use_device_loop=True)
    assert forwards[0] == 32 and set(forwards[1:]) == {1}  # prefill bucket, then steps
    assert len(copies) == len(forwards) - 1
    assert all(n == 2 for n, _ in copies)  # the float cache's K and V
    assert any(not torch.equal(src, torch.arange(src.numel())) for _, src in copies)


def test_default_decode_full_with_patience_matches_jax(setup):
    """decode_full's default route is the host loop, as JAX's: beam with
    patience gives JAX's results, and a greedy DecodingTask.run ignores
    use_topk_device (only JAX's beam reads it)."""
    cfg, jparams, jvocab, enc, decoder, vocab, (ck, cv) = setup
    kw = dict(beam_size=2, patience=1.0, sample_len=12)
    ref = jax_decode_full(jparams, cfg, jvocab, enc.cross_k, enc.cross_v, JaxOptions(**kw))
    _assert_results_match(decode_full(decoder, vocab, ck, cv, DecodingOptions(**kw)), ref)
    options = DecodingOptions(sample_len=8)
    plain = DecodingTask(cfg, vocab, options, decoder).run(ck, cv)
    topk = DecodingTask(cfg, vocab, options, decoder).run(ck, cv, use_topk_device=True)
    assert [r.tokens for r in topk] == [r.tokens for r in plain]


def test_decoding_routes_that_stay_unported(setup):
    """The routes this file once pinned as unported now decode: beam with
    patience under the device loop (the host loop with the device top-k
    step, tokens as the plain host beam's) and best_of groups."""
    cfg, _, _, _, decoder, vocab, (ck, cv) = setup
    opts = DecodingOptions(beam_size=2, patience=1.5, sample_len=8)
    topk = decode_full(decoder, vocab, ck, cv, opts, use_device_loop=True)
    host = decode_full(decoder, vocab, ck, cv, opts, use_device_loop=False)
    assert [r.tokens for r in topk] == [r.tokens for r in host]
    sampled = decode_full(decoder, vocab, ck, cv,
                          DecodingOptions(temperature=0.5, best_of=2, sample_len=8))
    assert len(sampled) == 2 and all(r.temperature == 0.5 for r in sampled)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_decode_step_group_shared_cross_matches_tiled(setup, int8):
    """Cross batch G = 2 under a decoder batch G·k = 6: a padded prefill and
    one step give the logits of the same cross memory tiled per beam row."""
    cfg, _, _, _, decoder, _, (ck, cv) = setup
    k = 3
    if int8:
        ck, cv = tq.quantize_kv(ck), tq.quantize_kv(cv)
    tile = (lambda a: a.repeat_interleave(k, dim=1))
    tiled = ((tq.QuantKV(tile(ck.data), tile(ck.scale)), tq.QuantKV(tile(cv.data),
                                                                      tile(cv.scale)))
             if int8 else (tile(ck), tile(cv)))
    rng = np.random.default_rng(2)
    steps = [(torch.from_numpy(rng.integers(0, 50000, size=(2 * k, 32))), 0),
             (torch.from_numpy(rng.integers(0, 50000, size=(2 * k, 1))), 5)]
    caches = [init_cache(cfg, 2 * k, torch.float32, "cpu", ctx=40) for _ in range(2)]
    for tokens, n_past in steps:
        shared, _ = decode_step(decoder, tokens, n_past, caches[0], ck, cv)
        ref, _ = decode_step(decoder, tokens, n_past, caches[1], *tiled)
        np.testing.assert_allclose(shared.numpy(), ref.numpy(), atol=3e-4, rtol=0)


def test_beam_update_matches_jax_fuzz():
    """beam_update on the same candidates as JAX's, EOT forced at random
    ranks (also below the k-th non-EOT, a branch openai never considers),
    every output equal; and the host decoder agrees, as in JAX's
    tests/test_topk_beam.py."""
    EOT = 999
    k, G, SL, steps = 3, 2, 12, 8
    for seed in range(6):
        rng = np.random.default_rng(seed)
        GK = G * k
        first = np.arange(1, GK + 1).reshape(G, k) * 7
        tokens = np.full((G, k, SL), EOT)
        tokens[:, :, 0] = first
        sum_lp = rng.standard_normal((G, k)).astype(np.float32)
        fin = (np.full((G, k, SL), EOT), np.full((G, k), -1e30, np.float32),
               np.zeros((G, k), np.int64), np.zeros((G,), np.int64))
        j_state = [jnp.asarray(sum_lp), jnp.asarray(tokens, jnp.int32),
                   *(jnp.asarray(a, jnp.int32 if a.dtype != np.float32 else None) for a in fin)]
        t_state = [torch.from_numpy(sum_lp), torch.from_numpy(tokens),
                   *(torch.from_numpy(a) for a in fin)]
        host = BeamSearchDecoder(k, EOT)
        host_tokens, host_sum = first.reshape(GK, 1).copy(), sum_lp.reshape(GK).astype(np.float64)
        for step in range(1, steps):
            top_lp = rng.standard_normal((GK, k + 1)).astype(np.float32) * 2.0
            top_ids = np.stack([rng.choice(np.arange(1, 900), size=k + 1, replace=False)
                                for _ in range(GK)])
            for row in range(GK):
                if rng.random() < 0.5:
                    top_ids[row, rng.integers(0, k + 1)] = EOT
            jo = jax_beam.beam_update(jnp.asarray(top_lp), jnp.asarray(top_ids, jnp.int32),
                                      *j_state, step, k, EOT)
            to = device_beam.beam_update(torch.from_numpy(top_lp), torch.from_numpy(top_ids),
                                         *t_state, step, k, EOT)
            for a, b in zip(to, jo):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            j_state = [jo[0], jo[3], *jo[4:]]
            t_state = [to[0], to[3], *to[4:]]
            host_tokens, completed, host_src = host.update_from_topk(host_tokens, top_lp,
                                                                     top_ids, host_sum)
            np.testing.assert_array_equal(to[1].reshape(GK).numpy(), host_tokens[:, -1])
            np.testing.assert_array_equal(to[2].reshape(GK).numpy(), host_src % k)
            assert bool((to[7] >= k).all()) == completed
            if completed:
                break


def test_cow_assign_matches_jax_fuzz():
    """Over many random mixing steps: JAX's row assignment exactly, a
    bijection per group, sources never destinations, and no copy at all for
    a permutation of distinct parents."""
    rng = np.random.default_rng(0)
    G, k = 3, 5
    phys = np.tile(np.arange(k), (G, 1))
    for t in range(40):
        src = (np.stack([rng.permutation(k) for _ in range(G)]) if t % 7 == 3
               else rng.integers(0, k, size=(G, k)))
        jp, jc = jax_beam.cow_assign(jnp.asarray(phys, jnp.int32), jnp.asarray(src, jnp.int32), k)
        new_phys, copy_src = device_beam.cow_assign(torch.from_numpy(phys),
                                                    torch.from_numpy(src), k)
        np.testing.assert_array_equal(new_phys.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(copy_src.numpy(), np.asarray(jc))
        for g in range(G):
            assert sorted(new_phys[g].tolist()) == list(range(k))
            dsts = {r for r in range(k) if copy_src[g, r] != r}
            assert not dsts & {int(copy_src[g, r]) for r in dsts}
            if len(set(src[g])) == k:
                assert not dsts
        phys = new_phys.numpy()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "micro.bin"
    write_synthetic_ggml(path, micro_config(), seed=9)
    return (jax_load_model(str(path), use_native=False), load_model(str(path), device="cpu"),
            [synthetic_audio(16000 * s, seed=s) for s in (1, 2)])


def test_batch_transcriber_beam_matches_jax(models, monkeypatch):
    """BatchTranscriber routes beam options to the host loop, as JAX's does."""
    jax_model, model, audios = models
    kw = dict(beam_size=3, sample_len=12, without_timestamps=False)
    ref = JaxTranscriber(jax_model, 2, options=JaxOptions(**kw)).transcribe_batch(audios)
    runs, real_run = [], DecodingTask.run
    monkeypatch.setattr(DecodingTask, "run",
                        lambda self, *a, **kw: runs.append(1) or real_run(self, *a, **kw))
    out = BatchTranscriber(model, 2, options=DecodingOptions(**kw)).transcribe_batch(audios)
    _assert_results_match(out, ref)
    assert runs == [1]  # the host loop ran


def test_serving_step_beam_matches_jax(models):
    """The int8 serving step with beam 3: W8A8 encoder, int8 cross memory at
    batch 2 (group-shared), int8 self cache of 6 rows; fin_count and every
    finished sequence equal JAX's."""
    jax_model, model, audios = models
    batch, k, n_tok = 2, 3, 16
    jp = jq.fuse_decoder_qkv(jax.jit(jq.quantize_encoder_weights)(
        jax.jit(jq.quantize_decoder_weights)(jax_model.params)))
    step = jax.jit(jax_make_serving_step(jax_model, batch, n_tok, "int8", use_flash=False,
                                         beam_size=k))
    rt, rc = (np.asarray(a) for a in step(jp, jnp.asarray(audios[1])))
    prepared = model.with_params(prepare_serving_params(model.params))
    gt, gc = make_serving_step(prepared, batch, n_tok, "int8", beam_size=k)(audios[1])
    assert gt.shape == (batch, k, n_tok) and gc.shape == (batch,)
    np.testing.assert_array_equal(gc.numpy(), rc)
    for g in range(batch):
        np.testing.assert_array_equal(gt[g, :int(gc[g])].numpy(), rt[g, :int(rc[g])])
