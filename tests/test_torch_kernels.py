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
    assert fa.flash_attention.launches == fa.flash_attention.f32_launches == 0  # no kernel on the CPU


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


PLAN_SHAPES = ([(tq, tk, False) for tq in (1, 37, 128, 1500) for tk in (1, 37, 128, 1500)]
               + [(448, 448, True), (100, 300, True), (300, 100, True), (1, 1, True)])


@pytest.mark.parametrize("tq,tk,causal", PLAN_SHAPES)
def test_attention_tile_plan_covers_each_row_once_and_skips_only_dead_tiles(tq, tk, causal):
    plan = fa.attention_tile_plan(tq, tk, causal)
    rows = np.concatenate([np.arange(q0, q1) for q0, q1, _, _ in plan])
    np.testing.assert_array_equal(rows, np.arange(tq))  # every query row once
    bq, bk = fa.BLOCK_Q, fa.BLOCK_K
    for q0, q1, tiles, masked in plan:
        assert q0 % bq == 0 and 0 < q1 - q0 <= bq
        r = np.arange(q0, q1)[:, None]
        block_rows = np.arange(q0, q0 + bq)[:, None]  # the kernel computes padded rows too
        for n in range(-(-tk // bk)):
            key = np.arange(n * bk, (n + 1) * bk)[None, :]
            live = (key < tk) & ((not causal) | (key <= r))
            # loaded iff some real row sees some key of the tile
            assert (n < tiles) == bool(live.any()), (q0, n)
            if n < tiles:  # masked iff some slot of the tile is dead for some row
                dead = (key >= tk) | (causal & (key > block_rows))
                assert (n in masked) == bool(dead.any()), (q0, n)


@pytest.mark.parametrize("tq,tk,causal", [(37, 1, False), (200, 300, False), (300, 100, True),
                                          (130, 260, True)])
def test_attention_tile_plan_reproduces_the_plain_version(tq, tk, causal):
    """The bf16 kernel's schedule in numpy, f64: zero-filled K/V past tk,
    masks only on the plan's masked tiles, online softmax per key tile."""
    q, k, v = (a[0, 0].astype(np.float64) for a in _qkv(4, tq, tk, h=1))
    bq, bk = fa.BLOCK_Q, fa.BLOCK_K
    n_k = -(-tk // bk)
    kp, vp = (np.concatenate([a, np.zeros((n_k * bk - tk, 64))]) for a in (k, v))
    out = np.zeros((tq, 64))
    for q0, q1, tiles, masked in fa.attention_tile_plan(tq, tk, causal):
        qb = np.zeros((bq, 64))
        qb[:q1 - q0] = q[q0:q1]
        m, s_sum, acc = np.full(bq, -np.inf), np.zeros(bq), np.zeros((bq, 64))
        for n in range(tiles):
            s = qb @ kp[n * bk:(n + 1) * bk].T / 8.0
            if n in masked:
                key = np.arange(n * bk, (n + 1) * bk)[None, :]
                row = np.arange(q0, q0 + bq)[:, None]
                s = np.where((key >= tk) | (causal & (key > row)), -np.inf, s)
            m_new = np.maximum(m, s.max(1))
            p, corr = np.exp(s - m_new[:, None]), np.exp(m - m_new)
            s_sum, m = s_sum * corr + p.sum(1), m_new
            acc = acc * corr[:, None] + p @ vp[n * bk:(n + 1) * bk]
        out[q0:q1] = (acc / s_sum[:, None])[:q1 - q0]
    s = q @ k.T / 8.0  # the plain version's masked softmax, in f64
    if causal:
        s = np.where(np.arange(tk)[None, :] <= np.arange(tq)[:, None], s, -np.inf)
    p = np.exp(s - s.max(1, keepdims=True))
    np.testing.assert_allclose(out, p @ v / p.sum(1, keepdims=True), atol=1e-12)
