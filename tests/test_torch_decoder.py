"""Port decode_step vs whisper_tpu.model.decoder.decode_step at f32:
a padded prefill, then three single-token steps."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from whisper_tpu.model import decoder as jax_dec
from whisper_tpu.model.params import params_from_ggml
from whisper_tpu_torch.model import decoder as torch_dec
from whisper_tpu_torch.model.params import params_to_torch

from fixtures import micro_config, random_tensors


def test_decode_steps_match_jax():
    cfg = micro_config()
    host = params_from_ggml(random_tensors(cfg, seed=5), cfg)
    rng = np.random.default_rng(6)
    B, ctx = 2, 40
    shape = (cfg.n_text_layer, B, cfg.n_text_head, cfg.d_head_text, cfg.n_audio_ctx)
    cross_k = rng.standard_normal(shape).astype(np.float32) * 0.3
    cross_v = rng.standard_normal(shape).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, host)
    decoder = torch_dec.TextDecoder(params_to_torch(host, "cpu", torch.float32), cfg)
    jcache = jax_dec.init_cache(cfg, B, ctx=ctx)
    tcache = torch_dec.init_cache(cfg, B, torch.float32, "cpu", ctx=ctx)

    true_len = 3
    prefill = np.zeros((B, 32), np.int64)  # right-padded to the 32 bucket
    prefill[:, :true_len] = [[50257, 50358, 50362], [50257, 7, 50362]]
    # the last two steps carry ids JAX's gather wraps or clamps
    steps = [(prefill, 0), (np.array([[11], [400]]), true_len),
             (np.array([[cfg.n_vocab + 5], [-1]]), true_len + 1),
             (np.array([[50363], [220]]), true_len + 2)]
    for tokens, n_past in steps:
        jl, jcache = jax_dec.decode_step(jparams, jnp.asarray(tokens, jnp.int32), jnp.int32(n_past),
                                         jcache, jnp.asarray(cross_k), jnp.asarray(cross_v), cfg)
        tl, tcache = torch_dec.decode_step(decoder, torch.from_numpy(tokens), n_past, tcache,
                                           torch.from_numpy(cross_k), torch.from_numpy(cross_v))
        assert tl.dtype == torch.float32 and tl.shape == (B, tokens.shape[1], cfg.n_vocab)
        # 3e-4: the port's f32 bound against JAX; summation order differs.
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=3e-4)
        # Caches agree everywhere, including the padded prefill's garbage
        # columns past true_len that the next step overwrites.
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=1e-5)
        np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), atol=1e-5)
