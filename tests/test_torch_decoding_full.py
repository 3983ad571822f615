"""The rest of the host decode path, port vs JAX at f32 on the CPU (micro
fixtures): ``detect_language``, the device rules + top-k step
(``decode_step_topk``, ``rule_state_from_tokens``, ``vocab_topk``), the host
beam with ``use_topk_device``, and best_of groups.

Tolerances: language and token ids identical; probabilities and
log-probabilities within 1e-4 and 3e-4 (f32 sums in another order, the
port's logits within 3e-4 of JAX's). Sampling cannot match ``jax.random``:
best_of is held to JAX in structure (rows, ranker, result fields).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.decoding import sequence as jax_sequence
from whisper_tpu.decoding import topk_step as jax_topk
from whisper_tpu.decoding.device_loop import build_masks as jax_build_masks
from whisper_tpu.decoding.task import DecodingOptions as JaxOptions
from whisper_tpu.decoding.task import decode_full as jax_decode_full
from whisper_tpu.decoding.task import detect_language as jax_detect_language
from whisper_tpu.io.vocab import make_vocab as jax_make_vocab
from whisper_tpu.model.decoder import decode_step as jax_decode_step
from whisper_tpu.model.decoder import init_cache as jax_init_cache
from whisper_tpu.model.encoder import encode as jax_encode
from whisper_tpu.model.params import params_from_ggml as jax_params_from_ggml
from whisper_tpu_torch.decoding import sequence, topk_step
from whisper_tpu_torch.decoding.device_loop import build_masks
from whisper_tpu_torch.decoding.result import DecodingResult
from whisper_tpu_torch.decoding.task import (DecodingOptions, DecodingTask, decode_full,
                                             detect_language)
from whisper_tpu_torch.io.vocab import make_vocab
from whisper_tpu_torch.model.decoder import TextDecoder, decode_step, init_cache
from whisper_tpu_torch.model.params import params_from_ggml, params_to_torch

from fixtures import micro_config, random_tensors, synthetic_tokens


def _setup(n_vocab: int, seed: int, batch: int):
    """``batch`` encoded windows of one micro model, in both packages."""
    cfg = micro_config(n_vocab=n_vocab)
    tensors = random_tensors(cfg, seed=seed)
    jparams = jax.tree.map(jnp.asarray, jax_params_from_ggml(tensors, cfg))
    tokens = synthetic_tokens(51864)
    mel = np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    enc = jax_encode(jparams, jnp.asarray(mel), cfg)
    decoder = TextDecoder(params_to_torch(params_from_ggml(tensors, cfg), "cpu", torch.float32),
                          cfg)
    cross = tuple(torch.from_numpy(np.array(a)) for a in (enc.cross_k, enc.cross_v))
    return (cfg, jparams, jax_make_vocab(cfg.n_vocab, tokens, 51864), enc, decoder,
            make_vocab(cfg.n_vocab, tokens, 51864), cross)


@pytest.fixture(scope="module")
def english():
    return _setup(51864, seed=31, batch=2)


@pytest.fixture(scope="module")
def multilingual():
    return _setup(51865, seed=13, batch=3)


def test_detect_language_matches_jax(multilingual):
    cfg, jparams, jvocab, enc, decoder, vocab, (ck, cv) = multilingual
    want_langs, want_probs = jax_detect_language(jparams, cfg, jvocab, enc.cross_k, enc.cross_v)
    langs, probs = detect_language(decoder, vocab, ck, cv)
    assert langs == want_langs
    for p, w in zip(probs, want_probs):
        assert p.keys() == w.keys()
        assert max(abs(p[k] - w[k]) for k in w) < 1e-4
        assert abs(sum(p.values()) - 1.0) < 1e-3


@pytest.mark.parametrize("n_vocab", [51865, 51866])
def test_language_tokens_cover_the_releases(n_vocab):
    """99 languages on v1/v2 vocabularies, 100 (with yue) on large-v3's."""
    vocab = make_vocab(n_vocab, synthetic_tokens(51864), 51864)
    jvocab = jax_make_vocab(n_vocab, synthetic_tokens(51864), 51864)
    assert vocab.all_language_tokens == jvocab.all_language_tokens
    assert len(vocab.all_language_tokens) == (100 if n_vocab == 51866 else 99)
    for tok in vocab.all_language_tokens:
        assert vocab.language_of_token(tok) == jvocab.language_of_token(tok)
    with pytest.raises(KeyError):
        vocab.language_of_token(vocab.token_sot)


def test_vocab_topk_keeps_jax_tie_order():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 51866)).astype(np.float32)
    x[0, [7, 300, 9000, 51000]] = 10.0   # a four-way tie at the top
    x[1, [5, 6]] = 3.0                   # a tie inside the top k
    x[1, 100] = 9.0
    x[2, :] = -1e30                      # every id masked but two
    x[2, [42, 17]] = 0.0
    vals, ids = topk_step.vocab_topk(torch.from_numpy(x), 6)
    jvals, jids = jax_topk.vocab_topk(jnp.asarray(x), 6)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert ids[0, :4].tolist() == [7, 300, 9000, 51000]


def test_rule_state_from_tokens_matches_jax(english):
    beg = english[5].token_beg
    rng = np.random.default_rng(1)
    for n_sampled in (0, 1, 2, 6):
        hist = np.where(rng.random((5, n_sampled)) < 0.4, rng.integers(beg, beg + 40, (5, n_sampled)),
                        rng.integers(0, 50000, (5, n_sampled)))
        tokens = np.concatenate([np.tile([50257, 7, 8], (5, 1)), hist], axis=1)
        got = topk_step.rule_state_from_tokens(tokens, 3, beg)
        want = jax_topk.rule_state_from_tokens(tokens, 3, beg)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[3] == int(want[3])


@pytest.mark.parametrize("without_timestamps", [True, False])
@pytest.mark.parametrize("n_sampled", [0, 1, 3])
def test_decode_step_topk_matches_jax(english, without_timestamps, n_sampled):
    """After a prefill of the same history in both packages, one top-k step:
    identical ids, log-probabilities within 3e-4."""
    cfg, jparams, jvocab, enc, decoder, vocab, (ck, cv) = english
    beg = vocab.token_beg
    rng = np.random.default_rng(n_sampled)
    sampled = np.where(rng.random((2, n_sampled)) < 0.5,
                       beg + np.sort(rng.integers(0, 30, (2, n_sampled)), axis=1),
                       rng.integers(100, 5000, (2, n_sampled)))
    history = np.concatenate([np.tile([vocab.token_sot], (2, 1)), sampled], axis=1)
    prefix, last = history[:, :-1], history[:, -1:]
    k, mi = 4, (None if without_timestamps else 50)
    kw = dict(k=k, use_timestamps=not without_timestamps, max_initial_index=mi)

    jcache = jax_init_cache(cfg, 2, ctx=16)
    n_past = prefix.shape[1]
    if n_past:
        _, jcache = jax_decode_step(jparams, jnp.asarray(prefix, jnp.int32), jnp.int32(0), jcache,
                                    enc.cross_k, enc.cross_v, cfg)
    jsup, jblank = jax_build_masks(jvocab)
    jstate = jax_topk.rule_state_from_tokens(history, 1, beg)
    jlp, jids, jeot, _ = jax_topk.decode_step_topk(
        jparams, jnp.asarray(last, jnp.int32), jnp.int32(n_past), jcache, enc.cross_k,
        enc.cross_v, jsup, jblank, *jstate, cfg, **kw)

    cache = init_cache(cfg, 2, torch.float32, "cpu", ctx=16)
    if n_past:
        _, cache = decode_step(decoder, torch.from_numpy(prefix), 0, cache, ck, cv)
    sup, blank = build_masks(vocab, "cpu")
    state = topk_step.rule_state_from_tokens(history, 1, beg)
    lp, ids, eot_lp, _ = topk_step.decode_step_topk(
        decoder, torch.from_numpy(last), n_past, cache, ck, cv, sup, blank, *state, **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=3e-4, rtol=0)
    np.testing.assert_allclose(eot_lp.numpy(), np.asarray(jeot), atol=3e-4, rtol=0)


@pytest.mark.parametrize("without_timestamps", [True, False])
def test_host_beam_with_device_topk_matches_jax(english, without_timestamps):
    """Beam with patience under use_device_loop: the host loop with the
    device top-k step, in both packages; and it equals the plain host beam."""
    cfg, jparams, jvocab, enc, decoder, vocab, (ck, cv) = english
    kw = dict(beam_size=3, patience=1.0, sample_len=14, without_timestamps=without_timestamps)
    ref = jax_decode_full(jparams, cfg, jvocab, enc.cross_k, enc.cross_v, JaxOptions(**kw),
                          use_device_loop=True)
    out = decode_full(decoder, vocab, ck, cv, DecodingOptions(**kw), use_device_loop=True)
    host = decode_full(decoder, vocab, ck, cv, DecodingOptions(**kw), use_device_loop=False)
    assert [r.tokens for r in out] == [r.tokens for r in ref] == [r.tokens for r in host]
    for o, r in zip(out, ref):
        assert abs(o.avg_logprob - r.avg_logprob) < 1e-3
        assert abs(o.no_speech_prob - r.no_speech_prob) < 1e-4


def test_run_with_topk_uses_the_device_step(english, monkeypatch):
    """DecodingTask.run(use_topk_device=True) on a beam decoder takes
    decode_step_topk at every step after the first."""
    cfg, _, _, _, decoder, vocab, (ck, cv) = english
    calls, real = [], topk_step.decode_step_topk

    def spy(*args, **kwargs):
        calls.append(kwargs["k"])
        return real(*args, **kwargs)

    monkeypatch.setattr(topk_step, "decode_step_topk", spy)
    task = DecodingTask(cfg, vocab, DecodingOptions(beam_size=2, sample_len=6), decoder)
    results = task.run(ck, cv, use_topk_device=True)
    assert len(results) == 2 and calls and set(calls) == {3}


@pytest.mark.parametrize("length_penalty", [None, 0.6, 1.0])
def test_ranker_matches_jax_on_fixed_logprobs(length_penalty):
    rng = np.random.default_rng(3)
    tokens = [[list(range(n)) for n in rng.integers(1, 30, 5)] for _ in range(4)]
    logprobs = [list(rng.uniform(-40, -1, 5)) for _ in range(4)]
    got = sequence.MaximumLikelihoodRanker(length_penalty).rank(tokens, logprobs)
    want = jax_sequence.MaximumLikelihoodRanker(length_penalty).rank(tokens, logprobs)
    assert got == want


def test_best_of_groups_decode_and_rank(english, monkeypatch):
    """best_of at t > 0 decodes n_audio * best_of rows through the host loop
    (also under use_device_loop, as JAX routes it), ranks each window's
    samples by the length-normalised sum, and returns one result per window
    with JAX's fields."""
    cfg, jparams, jvocab, enc, decoder, vocab, (ck, cv) = english
    rows, ranked = [], []
    real_update = sequence.GreedyDecoder.update
    real_rank = sequence.MaximumLikelihoodRanker.rank

    def update_spy(self, tokens, logits, sum_logprobs):
        rows.append(tokens.shape[0])
        return real_update(self, tokens, logits, sum_logprobs)

    def rank_spy(self, tokens, logprobs):
        out = real_rank(self, tokens, logprobs)
        ranked.append((tokens, logprobs, out))
        return out

    monkeypatch.setattr(sequence.GreedyDecoder, "update", update_spy)
    monkeypatch.setattr(sequence.MaximumLikelihoodRanker, "rank", rank_spy)
    kw = dict(temperature=0.7, best_of=3, sample_len=10)
    results = decode_full(decoder, vocab, ck, cv, DecodingOptions(**kw), use_device_loop=True)
    want = jax_decode_full(jparams, cfg, jvocab, enc.cross_k, enc.cross_v, JaxOptions(**kw))
    assert rows and set(rows) == {2 * 3}
    (tokens, logprobs, chosen), = ranked
    assert [len(g) for g in tokens] == [3, 3]
    assert chosen == jax_sequence.MaximumLikelihoodRanker(None).rank(tokens, logprobs)
    assert len(results) == len(want) == 2
    assert [f.name for f in dataclasses.fields(results[0])] == [
        f.name for f in dataclasses.fields(DecodingResult)]
    for i, r in enumerate(results):
        assert r.tokens == tokens[i][chosen[i]]
        assert r.temperature == 0.7 and np.isfinite(r.avg_logprob)
        assert r.avg_logprob == pytest.approx(logprobs[i][chosen[i]] / (len(r.tokens) + 1))
        assert all(0 <= t < cfg.n_vocab for t in r.tokens)
