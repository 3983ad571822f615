"""Port encoder vs whisper_tpu.model.encoder.encode at f32 (within 3e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.model.encoder import encode as jax_encode
from whisper_tpu.model.params import params_from_ggml
from whisper_tpu_torch.model import encoder as encoder_module
from whisper_tpu_torch.model.decoder import TextDecoder
from whisper_tpu_torch.model.encoder import AudioEncoder, encode
from whisper_tpu_torch.model.params import params_to_torch
from whisper_tpu_torch.model.quant import quantize_decoder_weights, quantize_encoder_weights

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
    """A ``*_scale`` entry beside a float weight is refused, not misread."""
    cfg, host, _ = setup
    params = params_to_torch(host, "cpu", torch.float32)
    params["encoder"]["blocks"]["q_w_scale"] = torch.ones(cfg.n_audio_layer, cfg.n_audio_state)
    with pytest.raises(ValueError, match="q_w_scale"):
        AudioEncoder(params, cfg)
    params = quantize_decoder_weights(params_to_torch(host, "cpu", torch.float32))
    params["decoder"]["te"] = params["decoder"]["te"].float()
    with pytest.raises(ValueError, match="te_scale"):
        TextDecoder(params, cfg)


def test_partly_quantized_encoder_is_refused(setup):
    """W8A8 blocks need all six projections in int8: a block with some of
    them float would run neither path, so the tree is refused."""
    cfg, host, _ = setup
    params = quantize_encoder_weights(params_to_torch(host, "cpu", torch.float32))
    blocks = params["encoder"]["blocks"]
    blocks["mlp1_w"] = params_to_torch(host, "cpu", torch.float32)["encoder"]["blocks"]["mlp1_w"]
    del blocks["mlp1_w_scale"]
    with pytest.raises(ValueError, match="5 of the 6"):
        AudioEncoder(params, cfg)


def test_quantized_encoder_weights_run_w8a8(setup, monkeypatch):
    """The tree from ``quantize_encoder_weights`` is accepted and runs the
    W8A8 blocks: the LN and GELU sites quantize through ``ln_quant`` and
    ``gelu_quant``, the attention output through ``act_quant``, each given
    a contiguous tensor as the CUDA kernel needs."""
    cfg, host, mel = setup
    calls = []

    def spy(name):
        fn = getattr(encoder_module, name)

        def call(x, *args):
            assert x.is_contiguous(), name  # the CUDA kernel reads whole rows
            calls.append(name)
            return fn(x, *args)
        return call

    for name in ("act_quant", "ln_quant", "gelu_quant"):
        monkeypatch.setattr(encoder_module, name, spy(name))
    float_enc = AudioEncoder(params_to_torch(host, "cpu", torch.float32), cfg)
    params = quantize_encoder_weights(params_to_torch(host, "cpu", torch.float32))
    w8a8 = AudioEncoder(params, cfg)
    assert w8a8.blocks[0].q_w.dtype == torch.int8
    ref = float_enc(torch.from_numpy(mel)).hidden
    out = w8a8(torch.from_numpy(mel)).hidden
    L = cfg.n_audio_layer
    assert sorted(calls) == sorted(["ln_quant"] * 2 * L + ["gelu_quant"] * L + ["act_quant"] * L)
    # quantization noise, not wreckage: the bound tests/test_quant.py:267
    # holds JAX's W8A8 encoder to against its float one
    rel = (out - ref).abs().max() / ref.abs().max()
    assert 0 < rel < 0.1, rel
