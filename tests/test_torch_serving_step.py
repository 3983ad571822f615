"""The int8 serving step, port vs JAX at f32 on the CPU: the W8A8 encoder
with an int8 cross memory, one int8 decode step, and the whole
``make_serving_step`` after the benchmark's parameter preparation
(benchmark.py:298-310), int8 and bf16 routes, on one micro GGML fixture.

On the CPU every kernel wrapper takes its plain version, so these hold the
port's int8 path itself to JAX; chip_smoke.py runs it through the kernels.
The JAX quantizers run under ``jax.jit``, as run_benchmark runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.decoding.task import DecodingOptions as JaxOptions
from whisper_tpu.decoding.task import decode_full as jax_decode_full
from whisper_tpu.model import decoder as jax_dec
from whisper_tpu.model import quant as jq
from whisper_tpu.model.encoder import encode as jax_encode
from whisper_tpu.model.load import load_model as jax_load_model
from whisper_tpu.model.params import params_from_ggml
from whisper_tpu.utils.benchmark import make_serving_step as jax_make_serving_step
from whisper_tpu_torch.decoding.task import DecodingOptions, decode_full
from whisper_tpu_torch.kernels import cross_attention_int8 as k4
from whisper_tpu_torch.kernels import fused_quant as fq
from whisper_tpu_torch.model import decoder as torch_dec
from whisper_tpu_torch.model import quant as tq
from whisper_tpu_torch.model.encoder import AudioEncoder, encode
from whisper_tpu_torch.model.load import load_model
from whisper_tpu_torch.model.params import params_to_torch
from whisper_tpu_torch.utils.benchmark import make_serving_step, prepare_serving_params

from fixtures import micro_config, random_tensors, synthetic_audio, write_synthetic_ggml


def _jax_serving_params(params, int8: bool):
    """benchmark.py:298-310: decoder weights, encoder weights, QKV fuse."""
    if int8:
        params = jax.jit(jq.quantize_decoder_weights)(params)
        params = jax.jit(jq.quantize_encoder_weights)(params)
    return jq.fuse_decoder_qkv(params)


@pytest.fixture(scope="module")
def trees():
    cfg = micro_config()
    host = params_from_ggml(random_tensors(cfg, seed=2), cfg)
    jp = _jax_serving_params(jax.tree.map(jnp.asarray, host), int8=True)
    tp = prepare_serving_params(params_to_torch(host, "cpu", torch.float32))
    return cfg, jp, tp


def _share_moved(a, b) -> float:
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    assert d.max() <= 1, d.max()
    return float((d > 0).mean())


def test_w8a8_encode_with_int8_cross_matches_jax(trees):
    cfg, jp, tp = trees
    mel = np.random.default_rng(0).standard_normal(
        (2, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    ref = jax_encode(jp, jnp.asarray(mel), cfg, quantize_kv=True)
    out = encode(AudioEncoder(tp, cfg), torch.from_numpy(mel), quantize_kv=True)
    # 3e-4: the port's f32 bound; the int8 codes of the W8A8 blocks match,
    # so only f32 summation order is left.
    np.testing.assert_allclose(out.hidden.numpy(), np.asarray(ref.hidden), atol=3e-4)
    for name in ("cross_k", "cross_v"):
        g, r = getattr(out, name), getattr(ref, name)
        assert isinstance(g, tq.QuantKV) and g.data.dtype == torch.int8
        assert g.data.shape == (cfg.n_text_layer, 2, cfg.n_text_head, cfg.d_head_text,
                                cfg.n_audio_ctx)
        # codes within one level, on under 1% of them; scales within 1e-5
        assert _share_moved(g.data.numpy(), r.data) < 0.01, name
        np.testing.assert_allclose(g.scale.numpy(), np.asarray(r.scale), rtol=1e-5)
        deq = g.data.numpy() * g.scale.numpy()[..., None, :]
        deq_ref = np.asarray(r.data, np.float32) * np.asarray(r.scale)[..., None, :]
        # a moved code is one scale step: at most max|x| / 127 of its column
        assert np.abs(deq - deq_ref).max() <= 1.01 * np.asarray(r.scale).max(), name
    assert fq.act_quant.launches == fq.ln_quant.launches == fq.gelu_quant.launches == 0


def test_int8_decode_step_matches_jax(trees):
    """int8 weights, fused QKV, int8 self cache and int8 cross memory: a
    padded prefill, then two single-token steps."""
    cfg, jp, tp = trees
    rng = np.random.default_rng(6)
    B, ctx = 2, 40
    shape = (cfg.n_text_layer, B, cfg.n_text_head, cfg.d_head_text, cfg.n_audio_ctx)
    cross = [jax.jit(jq.quantize_kv)(jnp.asarray(rng.standard_normal(shape).astype(np.float32) * f))
             for f in (0.3, 1.0)]
    tcross = [tq.QuantKV(torch.from_numpy(np.asarray(c.data)), torch.from_numpy(np.asarray(c.scale)))
              for c in cross]
    decoder = torch_dec.TextDecoder(tp, cfg)
    assert decoder.blocks[0].qkv_w.dtype == decoder.te.dtype == torch.int8
    jcache = jax_dec.KVCache(*jq.init_quant_cache(cfg, B, ctx=ctx))
    tcache = torch_dec.KVCache(*tq.init_quant_cache(cfg, B, "cpu", ctx=ctx))
    prefill = np.zeros((B, 32), np.int64)  # right-padded to the 32 bucket
    prefill[:, :3] = [[50257, 50358, 50362], [50257, 7, 50362]]
    steps = [(prefill, 0), (np.array([[11], [400]]), 3), (np.array([[50363], [-1]]), 4)]
    for tokens, n_past in steps:
        jl, jcache = jax_dec.decode_step(jp, jnp.asarray(tokens, jnp.int32), jnp.int32(n_past),
                                         jcache, *cross, cfg)
        tl, tcache = torch_dec.decode_step(decoder, torch.from_numpy(tokens), n_past, tcache,
                                           *tcross)
        assert tl.dtype == torch.float32 and tl.shape == (B, tokens.shape[1], cfg.n_vocab)
        # 2e-3, not the f32 bound 3e-4: pv_out rounds p * v_scale to bf16,
        # and f32 noise at a rounding boundary moves a term by a bf16 ulp
        # (seen at 8.7e-4 on padded prefill rows, which nothing reads).
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3)
        for g, r in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
            assert _share_moved(g.data.numpy(), r.data) < 0.01
            # the same bf16 flip moves an amax, so a scale, by ~1e-4
            np.testing.assert_allclose(g.scale.numpy(), np.asarray(r.scale), rtol=1e-3)
    assert k4.cross_attention_int8.launches == 0


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "micro.bin"
    write_synthetic_ggml(path, micro_config(), seed=9)
    return (jax_load_model(str(path), use_native=False), load_model(str(path), device="cpu"),
            synthetic_audio(16000 * 30, seed=3))


def _first_divergence(a, b) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


@pytest.mark.parametrize("kv_dtype", ["int8", "bfloat16"])
def test_serving_step_matches_jax(models, kv_dtype):
    """The whole slice. int8: W8A8 encoder, int8 decoder weights, fused QKV,
    int8 cross memory and self cache; token agreement per row >= 0.9 (JAX's
    own int8-vs-f32 gate is 0.6, test_quant.py:286). bf16: f32 weights with
    a fused QKV and a bf16 self cache; identical tokens."""
    jax_model, model, audio = models
    batch, n_tok = 2, 24
    int8 = kv_dtype == "int8"
    jp = _jax_serving_params(jax_model.params, int8)
    step = jax.jit(jax_make_serving_step(jax_model, batch, n_tok, kv_dtype, use_flash=False))
    rt, rl = (np.asarray(a) for a in step(jp, jnp.asarray(audio)))
    weights = "int8" if int8 else "bfloat16"
    prepared = model.with_params(prepare_serving_params(model.params, weights, weights))
    gt, gl = make_serving_step(prepared, batch, n_tok, kv_dtype)(audio)
    assert gt.shape == (batch, n_tok) and gl.shape == (batch,)
    assert set(prepared.timers.totals) >= {"mel", "encode", "decode"}
    for i in range(batch):
        ref, got = rt[i, :rl[i]].tolist(), gt[i, :int(gl[i])].tolist()
        j = _first_divergence(ref, got)
        msg = f"row {i} parts at step {j}: jax {ref[j:j + 4]}, port {got[j:j + 4]}"
        if int8:
            agree = sum(a == b for a, b in zip(ref, got)) / max(min(len(ref), len(got)), 1)
            assert agree >= 0.9, msg
        else:
            assert got == ref, msg


def test_decode_full_takes_an_int8_cross_memory(models):
    """decode_full on a QuantKV cross memory (a bf16 self cache, as JAX's
    ``_cache_dtype`` picks) gives JAX's tokens."""
    jax_model, model, _ = models
    cfg = model.config
    mel = np.random.default_rng(4).standard_normal(
        (2, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    jp = _jax_serving_params(jax_model.params, int8=True)
    ref_enc = jax_encode(jp, jnp.asarray(mel), cfg, quantize_kv=True)
    ref = jax_decode_full(jp, cfg, jax_model.vocab, ref_enc.cross_k, ref_enc.cross_v,
                          JaxOptions(sample_len=16, without_timestamps=False),
                          use_device_loop=True)
    prepared = model.with_params(prepare_serving_params(model.params))
    enc = encode(prepared.encoder, torch.from_numpy(mel), quantize_kv=True)
    out = decode_full(prepared.decoder, prepared.vocab, enc.cross_k, enc.cross_v,
                      DecodingOptions(sample_len=16, without_timestamps=False),
                      use_device_loop=True)
    assert [r.tokens for r in out] == [r.tokens for r in ref]


def test_serving_step_refuses_what_is_not_ported(models):
    _, model, _ = models
    with pytest.raises(ValueError):  # beam_size is ported: test_torch_beam.py
        make_serving_step(model, 2, 8, "float16")
