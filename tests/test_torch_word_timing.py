"""Word timing, port vs JAX at f32 on the CPU (micro fixtures):
``cross_attention_probs`` within 3e-4 (the port's f32 bound against JAX),
and ``find_word_timestamps`` on the same inputs with identical words,
tokens and times (0.02 s ticks, rounded to 10 ms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.io.vocab import make_vocab as jax_make_vocab
from whisper_tpu.model.decoder import cross_attention_probs as jax_cross_attention_probs
from whisper_tpu.model.encoder import encode as jax_encode
from whisper_tpu.model.params import params_from_ggml as jax_params_from_ggml
from whisper_tpu.pipeline import word_timing as jax_word_timing
from whisper_tpu_torch.io.vocab import make_vocab
from whisper_tpu_torch.model import decoder as decoder_module
from whisper_tpu_torch.model.decoder import (TextDecoder, cross_attention_probs, decode_step,
                                             init_cache)
from whisper_tpu_torch.model.params import params_from_ggml, params_to_torch
from whisper_tpu_torch.pipeline import word_timing

from fixtures import micro_config, random_tensors, synthetic_tokens


@pytest.fixture(scope="module")
def setup():
    """One micro model in both packages, a vocabulary whose ids 1000-1199
    begin with a space (so the words split), and two encoded windows."""
    cfg = micro_config(n_vocab=51864)
    tensors = random_tensors(cfg, seed=23)
    jparams = jax.tree.map(jnp.asarray, jax_params_from_ggml(tensors, cfg))
    tokens = synthetic_tokens(cfg.n_vocab)
    for i in range(1000, 1200):
        tokens[i] = f" w{i}".encode()
    mel = np.random.default_rng(2).standard_normal(
        (2, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    enc = jax_encode(jparams, jnp.asarray(mel), cfg)
    decoder = TextDecoder(params_to_torch(params_from_ggml(tensors, cfg), "cpu", torch.float32),
                          cfg)
    cross = tuple(torch.from_numpy(np.array(a)) for a in (enc.cross_k, enc.cross_v))
    return (cfg, jparams, jax_make_vocab(cfg.n_vocab, tokens, cfg.n_vocab), enc, decoder,
            make_vocab(cfg.n_vocab, tokens, cfg.n_vocab), cross)


def test_cross_attention_probs_matches_jax(setup):
    cfg, jparams, _, enc, decoder, vocab, (ck, cv) = setup
    seq = np.array([[vocab.token_sot, 1001, 17, 1002, 60000, 3, vocab.token_eot, -2],
                    [vocab.token_sot, 5, 1100, 6, 7, 1101, 8, vocab.token_eot]])
    want = np.asarray(jax_cross_attention_probs(jparams, jnp.asarray(seq, jnp.int32),
                                                enc.cross_k, enc.cross_v, cfg))
    got = cross_attention_probs(decoder, torch.from_numpy(seq), ck, cv)
    assert got.dtype == torch.float32
    assert got.shape == (cfg.n_text_layer, 2, cfg.n_text_head, seq.shape[1], cfg.n_audio_ctx)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


def test_cross_probs_path_leaves_the_logits_as_they_are(setup):
    """Stepping the decoder blocks one by one, each returning its cross
    probabilities, gives decode_step's logits exactly: cross_attention_probs'
    forward is decode_step's."""
    cfg, _, _, _, decoder, vocab, (ck, cv) = setup
    seq = torch.tensor([[vocab.token_sot, 1001, 17, 1002]])
    logits, _ = decode_step(decoder, seq, 0, init_cache(cfg, 1, torch.float32, "cpu", ctx=4),
                            ck[:, :1], cv[:, :1])
    h = decoder_module._embed(decoder, seq, 0)
    cache = init_cache(cfg, 1, torch.float32, "cpu", ctx=4)
    for layer, block in enumerate(decoder.blocks):
        h, probs = block(h, cache, layer, ck[layer, :1], cv[layer, :1], 0)
        assert probs.shape == (1, cfg.n_text_head, 4, cfg.n_audio_ctx)
        torch.testing.assert_close(probs.sum(-1), torch.ones(1, cfg.n_text_head, 4))
    h = decoder_module.layer_norm(h, decoder.ln_w, decoder.ln_b)
    torch.testing.assert_close(torch.matmul(h.float(), decoder.te.float().T), logits,
                               atol=0, rtol=0)


@pytest.mark.parametrize("window", [0, 1])
@pytest.mark.parametrize("num_frames", [None, 40])
def test_find_word_timestamps_matches_jax(setup, window, num_frames):
    cfg, jparams, jvocab, enc, decoder, vocab, (ck, cv) = setup
    text = [1001, 17, 18, 1002, 1003, 19, vocab.token_beg + 20, 1004, 20, 21, 1005]
    initial = [vocab.token_sot]
    kw = dict(num_frames=num_frames, time_offset=1.5 * window)
    want = jax_word_timing.find_word_timestamps(
        jparams, cfg, jvocab, enc.cross_k[:, window:window + 1],
        enc.cross_v[:, window:window + 1], text, initial, **kw)
    got = word_timing.find_word_timestamps(decoder, vocab, ck[:, window:window + 1],
                                           cv[:, window:window + 1], text, initial, **kw)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert (g.word, g.tokens, g.start, g.end) == (w.word, w.tokens, w.start, w.end)
    assert word_timing.find_word_timestamps(decoder, vocab, ck[:, :1], cv[:, :1],
                                            [vocab.token_eot], initial) == []
