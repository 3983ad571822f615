"""Port decode_segment_device vs whisper_tpu's, greedy: identical tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.decoding import device_loop as jax_loop
from whisper_tpu.io.vocab import make_vocab
from whisper_tpu.model.decoder import init_cache as jax_init_cache
from whisper_tpu.model.encoder import encode as jax_encode
from whisper_tpu.model.params import params_from_ggml
from whisper_tpu_torch.decoding import device_loop as torch_loop
from whisper_tpu_torch.model.decoder import TextDecoder, init_cache
from whisper_tpu_torch.model.params import params_to_torch

from fixtures import micro_config, random_tensors, synthetic_tokens


@pytest.fixture(scope="module")
def setup():
    cfg = micro_config(n_vocab=51864)
    host = params_from_ggml(random_tensors(cfg, seed=21), cfg)
    jparams = jax.tree.map(jnp.asarray, host)
    vocab = make_vocab(cfg.n_vocab, synthetic_tokens(cfg.n_vocab), cfg.n_vocab)
    mel = np.random.default_rng(3).standard_normal(
        (3, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    enc = jax_encode(jparams, jnp.asarray(mel), cfg)
    decoder = TextDecoder(params_to_torch(host, "cpu", torch.float32), cfg)
    return cfg, jparams, vocab, enc, decoder


@pytest.mark.parametrize("use_timestamps", [False, True])
def test_device_loop_matches_jax(setup, use_timestamps):
    cfg, jparams, vocab, enc, decoder = setup
    sample_len = 24
    B = enc.cross_k.shape[1]
    init = [vocab.token_sot] + ([] if use_timestamps else [vocab.token_not])
    init_tokens = np.tile(np.array(init, np.int64), (B, 1))
    sup, blank = jax_loop.build_masks(vocab)
    jt, jl, jlp, jns = jax_loop.decode_segment_device(
        jparams, jnp.asarray(init_tokens, jnp.int32), len(init), 0, jax_init_cache(cfg, B),
        enc.cross_k, enc.cross_v, sup, blank, cfg, sample_len=sample_len,
        use_timestamps=use_timestamps)
    tsup, tblank = torch_loop.build_masks(vocab, "cpu")
    np.testing.assert_array_equal(tsup.numpy(), np.asarray(sup))
    np.testing.assert_array_equal(tblank.numpy(), np.asarray(blank))
    tt, tl, tlp, tns = torch_loop.decode_segment_device(
        decoder, torch.from_numpy(init_tokens), len(init), 0,
        init_cache(cfg, B, torch.float32, "cpu"),
        torch.from_numpy(np.array(enc.cross_k)), torch.from_numpy(np.array(enc.cross_v)),
        tsup, tblank, sample_len=sample_len, use_timestamps=use_timestamps)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # f32 tolerances: softmax and log-softmax sums in another order
    np.testing.assert_allclose(tns.numpy(), np.asarray(jns), atol=1e-4)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-3)


def test_sampling_needs_an_explicit_generator(setup):
    cfg, _, vocab, enc, decoder = setup
    B = enc.cross_k.shape[1]
    args = (decoder, torch.full((B, 1), vocab.token_sot), 1, 0,
            init_cache(cfg, B, torch.float32, "cpu"),
            torch.from_numpy(np.array(enc.cross_k)), torch.from_numpy(np.array(enc.cross_v)),
            *torch_loop.build_masks(vocab, "cpu"))
    with pytest.raises(ValueError, match="Generator"):
        torch_loop.decode_segment_device(*args, sample_len=4, temperature=0.7)
    runs = [torch_loop.decode_segment_device(
        *args[:4], init_cache(cfg, B, torch.float32, "cpu"), *args[5:], sample_len=6,
        temperature=0.7, generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert runs[0][0].shape == (B, 6)
    torch.testing.assert_close(runs[0][0], runs[1][0])  # same seed, same draws
