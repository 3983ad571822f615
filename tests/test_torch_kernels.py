"""Port kernel module and plain ops vs the JAX package, at f32 on the CPU.

The CUDA kernel itself cannot run here; chip_smoke.py holds it to
``flash_attention_reference`` on the card. These tests hold that plain
version (the one a CPU tensor takes) to the Pallas kernel run in interpret
mode, as tests/test_kernels.py runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.kernels import ops as jax_ops
from whisper_tpu.kernels.flash_attention import flash_attention as jax_flash
from whisper_tpu_torch.kernels import flash_attention as fa
from whisper_tpu_torch.kernels import ops


def _qkv(seed, tq, tk, b=1, h=2, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32) for t in (tq, tk, tk)]


@pytest.mark.parametrize("tq,tk,causal", [(256, 256, False), (200, 200, True),
                                          (100, 300, False), (300, 100, True)])
def test_flash_attention_matches_pallas_interpret(tq, tk, causal):
    q, k, v = _qkv(0, tq, tk)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, interpret=True))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    ours = fa.flash_attention(*t, causal=causal)  # CPU tensor: the plain version
    np.testing.assert_array_equal(ours.numpy(),
                                  fa.flash_attention_reference(*t, causal=causal).numpy())
    # 2e-4: the bound tests/test_kernels.py holds the Pallas kernel to;
    # the two differ only in f32 summation order.
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4)
    assert fa.flash_attention.launches == 0  # no kernel on the CPU


def test_flash_attention_rejects_what_the_kernel_cannot_take():
    q = torch.zeros(2, 3, 16, 64)
    with pytest.raises(ValueError):
        fa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError, match="d_head"):
        fa._check(torch.zeros(2, 3, 16, 32), torch.zeros(2, 3, 16, 32), torch.zeros(2, 3, 16, 32))
    with pytest.raises(TypeError):
        fa._check(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        fa._check(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        fa._check(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError, match="match"):
        fa._check(q, torch.zeros(2, 4, 16, 64), torch.zeros(2, 4, 16, 64))
    fa._check(q, torch.zeros(2, 3, 40, 64), torch.zeros(2, 3, 40, 64))


@pytest.mark.parametrize("mask_kind", [None, "bool", "additive"])
def test_sdpa_matches_jax(mask_kind):
    q, k, v = _qkv(1, 24, 40, b=2, h=3, d=16)
    rng = np.random.default_rng(2)
    mask = None
    if mask_kind == "bool":
        mask = rng.random((24, 40)) > 0.3
    elif mask_kind == "additive":
        mask = (rng.standard_normal((24, 40)) * 2).astype(np.float32)
    ref = jax_ops.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       mask=None if mask is None else jnp.asarray(mask))
    ours = ops.sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                    mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_elementwise_ops_and_layouts_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32) * 3
    w = rng.standard_normal((48,)).astype(np.float32)
    b = rng.standard_normal((48,)).astype(np.float32)
    W = rng.standard_normal((20, 48)).astype(np.float32)
    tx, tw, tb, tW = (torch.from_numpy(a) for a in (x, w, b, W))
    # f32 tolerances: moments and products sum in another order.
    np.testing.assert_allclose(ops.layer_norm(tx, tw, tb).numpy(),
                               np.asarray(jax_ops.layer_norm(jnp.asarray(x), w, b)), atol=1e-5)
    for impl in ("erf", "tanh"):
        np.testing.assert_allclose(ops.gelu(tx, impl).numpy(),
                                   np.asarray(jax_ops.gelu(jnp.asarray(x), impl)), atol=1e-6)
    np.testing.assert_allclose(ops.linear(tx, tW, tb[:20]).numpy(),
                               np.asarray(jax_ops.linear(jnp.asarray(x), W, b[:20])), atol=1e-5)
    heads = ops.split_heads(tx, 4)
    np.testing.assert_array_equal(heads.numpy(), np.asarray(jax_ops.split_heads(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(ops.merge_heads(heads).numpy(), x)
