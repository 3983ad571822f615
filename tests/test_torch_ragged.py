"""Ragged per-row positions at T = 1, the serving engine's decode step: the
port's ``decode_step`` with a (B,) ``n_past`` tensor against JAX's ragged
``decode_step`` (f32 cache and int8 cache), ``_apply_rules_device`` with a
(B,) ``step`` against JAX's, the K5 and K4 plain versions under the
(B, 1, T, C) mask against ``_kvmajor_sdpa`` and ``quant_sdpa``, and K4's
cluster split replayed with each row's own limit (ranks past a row's keys
add nothing)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.decoding import device_loop as jax_loop
from whisper_tpu.model import decoder as jax_dec
from whisper_tpu.model import quant as jq
from whisper_tpu.model.params import params_from_ggml
from whisper_tpu_torch.decoding import device_loop as torch_loop
from whisper_tpu_torch.kernels import cross_attention_int8 as k4
from whisper_tpu_torch.kernels import decode_attention as k5
from whisper_tpu_torch.model import decoder as torch_dec
from whisper_tpu_torch.model import quant as tq
from whisper_tpu_torch.model.params import params_to_torch

from fixtures import micro_config, random_tensors
from test_torch_int8_kernels import _split_replay

C = 12  # cache positions
# rows at the first and last column, in the middle, and two past the cache
# (JAX drops those writes and clamps their positional gather)
N_PAST = np.array([0, 5, C - 1, C + 2], np.int32)


@pytest.fixture(scope="module")
def setup():
    cfg = micro_config()
    host = params_from_ggml(random_tensors(cfg, seed=21), cfg)
    return (cfg, jax.tree.map(jnp.asarray, host),
            torch_dec.TextDecoder(params_to_torch(host, "cpu", torch.float32), cfg))


def _cross(cfg, rng, B):
    shape = (cfg.n_text_layer, B, cfg.n_text_head, cfg.d_head_text, cfg.n_audio_ctx)
    return (rng.standard_normal(shape).astype(np.float32) * 0.3,
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("cache_kind", ["float32", "int8"])
def test_ragged_decode_step_matches_jax(setup, cache_kind):
    """Three ragged steps over a filled cache, every row at its own
    position (each advancing by one, two rows past the cache): logits within
    3e-4 (summation order), and the whole cache as JAX leaves it: the
    written columns equal, every other column untouched."""
    cfg, jparams, decoder = setup
    rng = np.random.default_rng(22)
    B = len(N_PAST)
    cross_k, cross_v = _cross(cfg, rng, B)
    shape = (B, cfg.n_text_layer, cfg.n_text_head, cfg.d_head_text, C)
    if cache_kind == "float32":
        k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        jcache = jax_dec.KVCache(jnp.asarray(k0), jnp.asarray(v0))
        tcache = torch_dec.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    else:
        parts = [(rng.integers(-127, 128, shape, dtype=np.int8),
                  rng.random(shape[:3] + (C,), dtype=np.float32) * 0.02 + 1e-3)
                 for _ in range(2)]
        jcache = jax_dec.KVCache(*(jq.QuantKV(jnp.asarray(d), jnp.asarray(s)) for d, s in parts))
        tcache = torch_dec.KVCache(*(tq.QuantKV(torch.from_numpy(d.copy()),
                                                torch.from_numpy(s.copy())) for d, s in parts))
    n_past = N_PAST
    for step, ids in enumerate(([[11], [400], [50363], [-1]], [[7], [cfg.n_vocab + 3], [220], [9]],
                                [[50257], [12], [13], [14]])):
        tokens = np.array(ids, np.int64)
        jl, jcache = jax_dec.decode_step(jparams, jnp.asarray(tokens, jnp.int32),
                                         jnp.asarray(n_past), jcache, jnp.asarray(cross_k),
                                         jnp.asarray(cross_v), cfg)
        tl, tcache = torch_dec.decode_step(decoder, torch.from_numpy(tokens),
                                           torch.from_numpy(n_past), tcache,
                                           torch.from_numpy(cross_k), torch.from_numpy(cross_v))
        assert tl.dtype == torch.float32 and tl.shape == (B, 1, cfg.n_vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=3e-4, err_msg=f"step {step}")
        for got, ref in zip(tcache, jcache):
            if cache_kind == "float32":
                np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
            else:
                # codes equal but for a code moved by f32 noise at a rounding
                # boundary (one scale step), scales to their bf16 rounding
                moved = got.data.numpy() != np.asarray(ref.data)
                assert moved.mean() < 0.01
                assert np.abs(got.data.numpy().astype(int) - np.asarray(ref.data)).max() <= 1
                np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref.scale), rtol=1e-3)
        n_past = n_past + 1


def test_ragged_writes_only_each_rows_column(setup):
    """Row b's new K/V lands at column n_past[b] of every layer and nowhere
    else; a row whose n_past is past the cache keeps its cache, and its
    positional embedding is the last one (JAX's clamped gather), no raise."""
    cfg, _, decoder = setup
    rng = np.random.default_rng(23)
    B = len(N_PAST)
    cross_k, cross_v = (torch.from_numpy(a) for a in _cross(cfg, rng, B))
    cache = torch_dec.init_cache(cfg, B, torch.float32, "cpu", ctx=C)
    tokens = torch.tensor([[11], [12], [13], [14]])
    torch_dec.decode_step(decoder, tokens, torch.from_numpy(N_PAST), cache, cross_k, cross_v)
    for b, n in enumerate(N_PAST):
        written = cache.k[b].abs().sum(dim=(0, 1, 2)) > 0  # (C,)
        want = torch.zeros(C, dtype=torch.bool)
        if n < C:
            want[n] = True
        assert torch.equal(written, want), b
    # the positional gather clamps a position past n_text_ctx, as JAX's does
    far = torch.tensor([cfg.n_text_ctx + 5, 0, 1, 2], dtype=torch.int32)
    x = torch_dec._embed(decoder, tokens, far)
    assert torch.equal(x[0, 0], decoder.te[11] + decoder.pe[cfg.n_text_ctx - 1])


def test_ragged_equals_scalar_when_every_row_is_alike(setup):
    """A (B,) n_past with every row at the same position gives the scalar
    path's logits and cache, to the bit."""
    cfg, _, decoder = setup
    rng = np.random.default_rng(24)
    B = 3
    cross_k, cross_v = (torch.from_numpy(a) for a in _cross(cfg, rng, B))
    base = rng.standard_normal((B, cfg.n_text_layer, cfg.n_text_head, cfg.d_head_text, C))
    caches = [torch_dec.KVCache(torch.from_numpy(base.astype(np.float32)),
                                torch.from_numpy(base.astype(np.float32) * 0.5)) for _ in range(2)]
    tokens = torch.tensor([[3], [4], [5]])
    lg_int, _ = torch_dec.decode_step(decoder, tokens, 6, caches[0], cross_k, cross_v)
    lg_vec, _ = torch_dec.decode_step(decoder, tokens, torch.full((B,), 6, dtype=torch.int32),
                                      caches[1], cross_k, cross_v)
    assert torch.equal(lg_int, lg_vec)
    assert torch.equal(caches[0].k, caches[1].k) and torch.equal(caches[0].v, caches[1].v)


def test_ragged_multi_token_block_raises(setup):
    cfg, _, decoder = setup
    cache = torch_dec.init_cache(cfg, 2, torch.float32, "cpu", ctx=C)
    cross = torch.zeros(cfg.n_text_layer, 2, cfg.n_text_head, cfg.d_head_text, cfg.n_audio_ctx)
    with pytest.raises(NotImplementedError, match="item 14"):
        torch_dec.decode_step(decoder, torch.zeros(2, 3, dtype=torch.long),
                              torch.zeros(2, dtype=torch.int32), cache, cross, cross)


@pytest.mark.parametrize("use_timestamps", [True, False])
@pytest.mark.parametrize("max_initial_index", [50, None])
def test_rules_with_a_step_per_row_match_jax(use_timestamps, max_initial_index):
    """Each row at its own step (0 and 1: the first-token rules; 2 and 7:
    the pairing's penultimate check), against JAX's rules with the same
    (B,) step; an int step gives what the rows at that step give."""
    V = 51864
    eot, beg, not_, _ = 50256, 50363, 50362, V
    consts = (eot, beg, not_, V)
    rng = np.random.default_rng(25)
    B = 6
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    step = np.array([0, 1, 2, 7, 0, 2], np.int32)
    last = np.array([-1, beg + 3, 220, beg + 9, -1, beg + 4], np.int64)
    prev = np.array([-1, -1, beg + 3, beg + 2, -1, 17], np.int64)
    last_ts = np.array([-1, beg + 3, beg + 3, beg + 9, -1, beg + 4], np.int64)
    sup = rng.random(V) < 0.01
    blank = np.zeros(V, bool)
    blank[[220, eot]] = True
    jstate = jax_loop.LoopState(None, None, None, jnp.asarray(last, jnp.int32),
                                jnp.asarray(prev, jnp.int32), jnp.asarray(last_ts, jnp.int32),
                                None, None, None, None)
    ref = np.asarray(jax_loop._apply_rules_device(
        jnp.asarray(logits), jnp.asarray(step), jstate, jnp.asarray(sup), jnp.asarray(blank),
        consts, use_timestamps, max_initial_index))
    tstate = torch_loop.RuleState(*(torch.from_numpy(a) for a in (last, prev, last_ts)))
    args = (tstate, torch.from_numpy(sup), torch.from_numpy(blank), consts, use_timestamps,
            max_initial_index)
    got = torch_loop._apply_rules_device(torch.from_numpy(logits), torch.from_numpy(step), *args)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    for s in (0, 2):
        rows = step == s
        by_int = torch_loop._apply_rules_device(torch.from_numpy(logits), s, *args)
        assert torch.equal(by_int[torch.from_numpy(rows)], got[torch.from_numpy(rows)])


def _mask(n_past, T, Cn):
    return (np.arange(Cn)[None, None, None, :]
            <= n_past[:, None, None, None] + np.arange(T)[None, None, :, None])


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_plain_with_a_row_tensor_matches_kvmajor_sdpa(T, dtype):
    """cached_attention_reference with (B,) n_past (rows at 0, C - 1 and
    past C) against JAX's _kvmajor_sdpa under the (B, 1, T, C) mask."""
    rng = np.random.default_rng(26 + T)
    B, H = len(N_PAST), 2
    q = rng.standard_normal((B, H, T, 64)).astype(np.float32) * 0.3
    k = rng.standard_normal((B, H, 64, C)).astype(np.float32)
    v = rng.standard_normal((B, H, 64, C)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jax.jit(jax_dec._kvmajor_sdpa, static_argnums=4)(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), jnp.asarray(_mask(N_PAST, T, C)),
        64 ** -0.5), np.float32)
    got = k5.cached_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                              torch.from_numpy(N_PAST))
    tol = dict(atol=1e-5) if dtype == "float32" else dict(rtol=2 ** -7, atol=2e-3)
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)
    # every row alike: the tensor call is the int call
    same = torch.full((B,), 4, dtype=torch.int32)
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    assert torch.equal(k5.cached_attention(*args, same), k5.cached_attention(*args, 4))


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_plain_with_a_row_tensor_matches_quant_sdpa(T, dtype):
    """cross_attention_int8_reference with (B,) n_past against JAX's
    quant_sdpa under the (B, 1, T, C) mask."""
    rng = np.random.default_rng(28 + T)
    B, H = len(N_PAST), 2
    q = rng.standard_normal((B, H, T, 64)).astype(np.float32) * 0.3
    kq, vq = (jax.jit(jq.quantize_kv)(jnp.asarray(rng.standard_normal((B, H, 64, C)),
                                                  jnp.float32)) for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jax.jit(jq.quant_sdpa, static_argnums=4)(
        jnp.asarray(q).astype(jdt), kq, vq, jnp.asarray(_mask(N_PAST, T, C)), jdt), np.float32)
    args = (torch.from_numpy(q).to(tdt), *(torch.from_numpy(np.array(a))
                                           for a in (kq.data, kq.scale, vq.data, vq.scale)))
    got = k4.cross_attention_int8(*args, n_past=torch.from_numpy(N_PAST))
    tol = dict(atol=1e-5) if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-3)
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)
    same = torch.full((B,), 4, dtype=torch.int32)
    assert torch.equal(k4.cross_attention_int8(*args, n_past=same),
                       k4.cross_attention_int8(*args, n_past=4))


@pytest.mark.parametrize("ranks", [None, 2, 3, 8])
def test_k4_ragged_split_with_empty_ranks_matches_quant_sdpa(ranks):
    """The kernel's split with a ragged call's plan (sized for all C keys,
    cross_attention_int8_plan(C, 1, C - 1)) and each row's own limit: a row
    at n_past 0 leaves every rank but the first with no key, and those ranks
    add a max of -1e30 and a sum of 0, never NaN."""
    rng = np.random.default_rng(31)
    Cb, B, H = 203, 4, 2
    n_past = np.array([0, 1, 100, Cb - 1], np.int32)
    q = rng.standard_normal((B, H, 1, 64)).astype(np.float32) * 0.3
    kq, vq = (jax.jit(jq.quantize_kv)(jnp.asarray(rng.standard_normal((B, H, 64, Cb)),
                                                  jnp.float32)) for _ in range(2))
    ref = np.asarray(jax.jit(jq.quant_sdpa, static_argnums=4)(
        jnp.asarray(q), kq, vq, jnp.asarray(_mask(n_past, 1, Cb)), jnp.float32))
    plan = k4.cross_attention_int8_plan(Cb, 1, Cb - 1, ranks)
    assert plan.ranges[-1][1] == Cb  # the whole cache
    args = (torch.from_numpy(q), *(torch.from_numpy(np.array(a))
                                   for a in (kq.data, kq.scale, vq.data, vq.scale)))
    got = _split_replay(*args, torch.from_numpy(n_past).reshape(-1, 1, 1, 1), plan)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_ragged_plans_cover_the_whole_cache():
    """The wrappers size a ragged launch from C alone (the host cannot know
    the largest n_past[b] without a sync): K5's plan holds every key's
    logits, K4's ranges tile all C keys."""
    for c_len, esz in ((75, 1), (75, 2), (104, 2), (448, 2), (448, 4)):
        plan = k5.cached_attention_plan(c_len, 1, c_len - 1, esz)
        assert plan.smem <= k5.SMEM_MAX and plan.rows == 1
        assert -(-c_len // plan.width) * plan.width >= c_len
    for c_len in (75, 448, 1500):
        plan = k4.cross_attention_int8_plan(c_len, 1, c_len - 1)
        assert [c for a, b in plan.ranges for c in range(a, b)] == list(range(c_len))


def test_row_tensor_is_checked():
    """A per-row n_past must be a (B,) int32 tensor on q's device; on a CUDA
    q the wrappers check this before any launch (here, the check itself)."""
    q = torch.zeros(2, 1, 1, 64)
    k5.check_rows(torch.zeros(2, dtype=torch.int32), q, "t")
    for bad in (torch.zeros(2, dtype=torch.int64), torch.zeros(3, dtype=torch.int32),
                torch.zeros(4, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError, match="int32"):
            k5.check_rows(bad, q, "t")
