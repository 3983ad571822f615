"""Port model/quant.py vs whisper_tpu.model.quant on the same numpy inputs.

The JAX quantizers run under ``jax.jit``, as the package runs them (XLA
then divides by 127 as a product with its reciprocal, which eager JAX does
not). Weight quantizers, ``_quantize_one``, ``quantize_act`` and
``q8_matmul`` are bit-exact at f32 (and ``_quantize_one`` in bf16); the
attention pieces ``qk_logits``/``pv_out``/``quant_sdpa`` agree within 1e-5
(f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.model import quant as jq
from whisper_tpu.model.params import params_from_ggml
from whisper_tpu_torch.model import quant as tq
from whisper_tpu_torch.model.params import params_to_torch

from fixtures import micro_config, random_tensors


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


_PREPS = {
    "decoder": lambda m: m.quantize_decoder_weights,
    "encoder": lambda m: m.quantize_encoder_weights,
    "fuse-float": lambda m: m.fuse_decoder_qkv,
    "serving": lambda m: (lambda p: m.fuse_decoder_qkv(
        m.quantize_encoder_weights(m.quantize_decoder_weights(p)))),
}


@pytest.mark.parametrize("prep", sorted(_PREPS))
def test_weight_trees_match_jax(prep):
    cfg = micro_config()
    host = params_from_ggml(random_tensors(cfg, seed=3), cfg)
    ref = _flat(jax.tree.map(np.asarray, jax.jit(_PREPS[prep](jq))(jax.tree.map(jnp.asarray, host))))
    got = _flat(_PREPS[prep](tq)(params_to_torch(host, "cpu", torch.float32)))
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        g = got[name].numpy()
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_quantize_weight_matches_jax():
    w = np.random.default_rng(0).standard_normal((3, 40, 24)).astype(np.float32)
    w[1, 5] = 0.0  # an all-zero row takes the 1e-8 floor
    rq, rs = jax.jit(jq.quantize_weight)(jnp.asarray(w))
    gq, gs = tq.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_one_matches_jax(dtype):
    x = np.random.default_rng(1).standard_normal((2, 3, 16, 21)).astype(np.float32) * 3
    x[0, 1, :, 4] = 0.0  # a zero column
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = jax.jit(jq._quantize_one)(jx)
    got = tq._quantize_one(tx)
    assert got.data.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    # 5-D, layer by layer
    x5 = np.stack([x, -x * 0.5])
    ref5 = jax.jit(jq.quantize_kv)(jnp.asarray(x5))
    got5 = tq.quantize_kv(torch.from_numpy(x5))
    np.testing.assert_array_equal(got5.data.numpy(), np.asarray(ref5.data))
    np.testing.assert_array_equal(got5.scale.numpy(), np.asarray(ref5.scale))


def test_quantize_act_and_q8_matmul_match_jax():
    rng = np.random.default_rng(2)
    y = rng.standard_normal((2, 37, 64)).astype(np.float32) * 2
    w = rng.standard_normal((48, 64)).astype(np.float32) * 0.1
    b = rng.standard_normal(48).astype(np.float32)
    r8, rs = jax.jit(jq.quantize_act)(jnp.asarray(y))
    g8, gs = tq.quantize_act(torch.from_numpy(y))
    np.testing.assert_array_equal(g8.numpy(), np.asarray(r8))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    w8, ws = jax.jit(jq.quantize_weight)(jnp.asarray(w))
    tw8, tws = torch.from_numpy(np.asarray(w8)), torch.from_numpy(np.asarray(ws))
    jit_q8 = jax.jit(jq.q8_matmul, static_argnums=5)
    ref = jit_q8(r8, rs, w8, ws, None, jnp.float32)
    got = tq.q8_matmul(g8, gs, tw8, tws, None, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 37, 48)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # With a bias XLA contracts the dequant product and the add into an
    # FMA, which the port does not: 1 ulp apart at most, of the product or
    # of the sum, whichever is larger.
    ref_b = np.asarray(jit_q8(r8, rs, w8, ws, jnp.asarray(b), jnp.float32))
    got_b = tq.q8_matmul(g8, gs, tw8, tws, torch.from_numpy(b), torch.float32).numpy()
    ulp = np.spacing(np.maximum(np.abs(got.numpy()), np.abs(got_b)))
    assert (np.abs(got_b - ref_b) <= ulp).all()
    ref = jax.jit(jq.dyn_qlinear)(jnp.asarray(y), w8, ws)
    got = tq.dyn_qlinear(torch.from_numpy(y), torch.from_numpy(np.asarray(w8)),
                         torch.from_numpy(np.asarray(ws)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _qkv8(seed, B=2, H=3, T=4, D=16, C=29):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32) * 0.5
    k = rng.standard_normal((B, H, D, C)).astype(np.float32)
    v = rng.standard_normal((B, H, D, C)).astype(np.float32)
    kq, vq = (jax.jit(jq._quantize_one)(jnp.asarray(a)) for a in (k, v))
    return q, kq, vq


def _t(kv):
    return tq.QuantKV(torch.from_numpy(np.asarray(kv.data)), torch.from_numpy(np.asarray(kv.scale)))


@pytest.mark.parametrize("n_past", [None, 0, 7, 25])
def test_quant_attention_matches_jax(n_past):
    q, kq, vq = _qkv8(4)
    T, C = q.shape[2], kq.data.shape[-1]
    # 1e-5: f32 products of exactly converted operands, summed in another order.
    np.testing.assert_allclose(tq.qk_logits(torch.from_numpy(q), _t(kq)).numpy(),
                               np.asarray(jq.qk_logits(jnp.asarray(q), kq)), atol=1e-5)
    probs = jax.nn.softmax(jnp.asarray(q[..., :1].repeat(C, -1)), axis=-1)
    np.testing.assert_allclose(tq.pv_out(torch.from_numpy(np.asarray(probs)), _t(vq),
                                         torch.float32).numpy(),
                               np.asarray(jq.pv_out(probs, vq, jnp.float32)), atol=1e-5)
    mask = None
    if n_past is not None:  # the decoder's causal rule, key <= n_past + t
        mask = np.arange(C)[None, :] <= n_past + np.arange(T)[:, None]
    ref = jq.quant_sdpa(jnp.asarray(q), kq, vq, True if mask is None else jnp.asarray(mask),
                        jnp.float32)
    got = tq.quant_sdpa(torch.from_numpy(q), _t(kq), _t(vq),
                        None if mask is None else torch.from_numpy(mask), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_init_quant_cache_layout():
    cfg = micro_config()
    k, v = tq.init_quant_cache(cfg, 3, "cpu", ctx=20)
    rk, _ = jq.init_quant_cache(cfg, 3, ctx=20)
    assert k.data.shape == rk.data.shape and k.scale.shape == rk.scale.shape
    assert k.data.dtype == torch.int8 and k.scale.dtype == torch.float32
    assert k.data.data_ptr() != v.data.data_ptr() and k.scale.data_ptr() != v.scale.data_ptr()
    assert tq.init_quant_cache(cfg, 1, "cpu", ctx=10_000)[0].data.shape[-1] == cfg.n_text_ctx
