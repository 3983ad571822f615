"""Port encoder vs whisper_tpu.model.encoder.encode at f32 (within 3e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.model.encoder import encode as jax_encode
from whisper_tpu.model.params import params_from_ggml
from whisper_tpu_torch.model.encoder import AudioEncoder, encode
from whisper_tpu_torch.model.params import params_to_torch

from fixtures import micro_config, random_tensors


@pytest.fixture(scope="module")
def setup():
    cfg = micro_config()
    host = params_from_ggml(random_tensors(cfg, seed=2), cfg)
    mel = np.random.default_rng(0).standard_normal(
        (2, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    return cfg, host, mel


@pytest.mark.parametrize("use_flash", [False, True])
def test_encoder_matches_jax(setup, use_flash):
    """use_flash=True runs the Pallas kernel in interpret mode on the CPU."""
    cfg, host, mel = setup
    ref = jax_encode(jax.tree.map(jnp.asarray, host), jnp.asarray(mel), cfg,
                     use_flash=use_flash)
    encoder = AudioEncoder(params_to_torch(host, "cpu", torch.float32), cfg)
    out = encode(encoder, torch.from_numpy(mel))
    assert out.cross_k.shape == (cfg.n_text_layer, 2, cfg.n_text_head,
                                 cfg.d_head_text, cfg.n_audio_ctx)
    # 3e-4: the port's f32 bound against JAX (ROADMAP); only summation
    # order differs.
    for name in ("hidden", "cross_k", "cross_v"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=3e-4, err_msg=name)


def test_encoder_bf16_runs_in_weight_dtype(setup):
    cfg, host, mel = setup
    encoder = AudioEncoder(params_to_torch(host, "cpu", torch.bfloat16), cfg)
    out = encoder(torch.from_numpy(mel))  # f32 mel must not lift the model to f32
    assert out.hidden.dtype == out.cross_k.dtype == torch.bfloat16
    assert torch.isfinite(out.hidden.float()).all()


def test_quantized_weights_are_refused(setup):
    cfg, host, _ = setup
    params = params_to_torch(host, "cpu", torch.float32)
    params["encoder"]["blocks"]["q_w_scale"] = torch.ones(cfg.n_audio_layer, cfg.n_audio_state)
    with pytest.raises(NotImplementedError, match="q_w_scale"):
        AudioEncoder(params, cfg)
