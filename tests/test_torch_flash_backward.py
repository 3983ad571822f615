"""K1c's new contract against the JAX package on the CPU: the forward's row
statistics (``flash_attention_lse_reference``), the backward from ``(q, k,
v, out, lse, g)`` (``flash_sdpa_backward``, the plain version of
``csrc/flash_attention_bwd.cu``) and through ``flash_sdpa``'s autograd,
in f32 and bf16, with and without causal, at sizes that are not multiples
of the kernels' tiles; and the tile plans of the f32 forward and of the
backward kernel. The CUDA kernels cannot run here; chip_smoke.py's phase 13
holds them to these plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.kernels.flash_attention import flash_sdpa as jax_flash_sdpa
from whisper_tpu_torch.kernels import flash_attention as fa

# lse against jax.nn.logsumexp of the same f32 scores: only the order of
# the f32 sums (and of exp) differs.
LSE_TOL = (1e-5, 1e-6)
# f32 gradients against JAX's VJP: both recompute the same f32 scores; p
# comes from lse here and from a softmax there, delta from rowsum(g ⊙ out)
# here and Σ dp·p there, and the sums run in another order. Measured: within
# 2.4e-6 of gradients whose largest elements are 0.8-4.5; the bound is the
# one tests/test_torch_training.py holds flash_sdpa to.
F32_TOL = (2e-4, 1e-3)
# bf16: both sides compute in f32 from the same bf16 inputs and round each
# gradient to bf16 once, so an f32 difference at a rounding boundary moves
# an element by one bf16 ulp, 2^-7 of its magnitude at most.
BF16_TOL = (1e-5, 2 ** -7)
# A bf16 output (K1's bf16 bound in chip_smoke.py): both sides round p to
# bf16 before P V, and an exp an f32 ulp apart can move one p by a bf16 ulp.
OUT_BF16_TOL = (1e-2, 2 ** -7)
SIZES = [(75, 37, False), (37, 75, False), (75, 75, True), (130, 130, True)]


def _inputs(seed, tq, tk, dtype, b=2, h=3):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, h, t, 64)).astype(np.float32) for t in (tq, tk, tk, tq)]
    return [torch.from_numpy(a).to(dtype) for a in arrays]  # q, k, v, g


def _jax(t):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16 if t.dtype == torch.bfloat16
                       else jnp.float32)


def _close(got, want, tol):
    atol, rtol = tol
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("tq,tk,causal", [(75, 37, False), (37, 75, False), (75, 75, True),
                                          (40, 90, True), (90, 40, True)])
def test_lse_reference_matches_jax_logsumexp(tq, tk, causal):
    q, k, v, _ = _inputs(1, tq, tk, torch.float32)
    out, lse = fa.flash_attention_lse_reference(q, k, v, causal)
    assert lse.shape == q.shape[:-1] and lse.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(),
                                  fa.flash_attention_reference(q, k, v, causal).numpy())
    s = jnp.einsum("...td,...cd->...tc", _jax(q) * 64 ** -0.5, _jax(k))
    if causal:  # the forward's rule: key <= query from the first query
        s = jnp.where(jnp.arange(tk)[None, :] <= jnp.arange(tq)[:, None], s, -1e30)
    _close(lse, jax.nn.logsumexp(s, axis=-1), LSE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,causal", SIZES)
def test_backward_matches_jax_vjp(tq, tk, causal, dtype):
    """The plain backward from the forward's (out, lse), called directly and
    through flash_sdpa's autograd, against jax.vjp of JAX's flash_sdpa
    (its forward in interpret mode, its backward XLA einsums). Causal cases
    have tq == tk, where JAX's backward mask agrees with the forward's."""
    q, k, v, g = _inputs(2, tq, tk, dtype)
    out, lse = fa.flash_attention_lse_reference(q, k, v, causal)
    grads = fa.flash_sdpa_backward(q, k, v, out, lse, g, causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(fa.flash_sdpa(*leaves, causal), leaves, g)
    ref_out, vjp = jax.vjp(lambda q, k, v: jax_flash_sdpa(q, k, v, causal), _jax(q), _jax(k),
                           _jax(v))
    f32 = dtype == torch.float32
    tol = F32_TOL if f32 else BF16_TOL
    _close(out, np.asarray(ref_out, np.float32), F32_TOL if f32 else OUT_BF16_TOL)
    for got, via_autograd, want in zip(grads, auto, vjp(_jax(g))):
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), via_autograd.float().numpy())
        _close(got, want, tol)


def test_bf16_delta_is_not_taken_from_the_rounded_output():
    """V rows close to one another make dp ≈ delta for every key, so ds =
    p ⊙ (dp − delta) is a small difference of large numbers. The bf16
    output rounds p to bf16 and itself to bf16 (2^-8 of ~1 per element):
    delta = rowsum(g ⊙ out) would then move dq and dk far past the bf16
    bound, while the plain backward's rowsum(g ⊙ p v) in f32 stays within
    it."""
    q, k, v, g = _inputs(3, 75, 75, torch.bfloat16)
    v = (1 + 0.01 * v.float()).to(torch.bfloat16)
    out, lse = fa.flash_attention_lse_reference(q, k, v, False)
    dq, dk, dv = fa.flash_sdpa_backward(q, k, v, out, lse, g, False)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_sdpa(q, k, v, False), _jax(q), _jax(k), _jax(v))
    want = vjp(_jax(g))
    for got, w in zip((dq, dk, dv), want):
        _close(got, w, BF16_TOL)
    # the same closed form with delta from the bf16 output
    p = fa._scores(q, k, False).sub_(lse.unsqueeze(-1)).exp_()
    g32 = g.float()
    ds = (g32 @ v.float().transpose(-1, -2) - (g32 * out.float()).sum(-1, keepdim=True)) * p / 8
    wrong_dq = (ds @ k.float()).to(torch.bfloat16)
    with pytest.raises(AssertionError):
        _close(wrong_dq, want[0], BF16_TOL)
    want_dq = torch.from_numpy(np.asarray(want[0], np.float32))
    assert (wrong_dq.float() - want_dq).abs().max() > 10 * (dq.float() - want_dq).abs().max()


def test_flash_sdpa_without_a_gradient_is_flash_attention():
    """Under no_grad, or with no input that requires a gradient, flash_sdpa
    builds no graph (on the card: no row statistics are written)."""
    q, k, v, _ = _inputs(4, 40, 40, torch.float32)
    want = fa.flash_attention(q, k, v, causal=True)
    plain = fa.flash_sdpa(q, k, v, True)
    assert plain.grad_fn is None
    with torch.no_grad():
        out = fa.flash_sdpa(q.requires_grad_(), k, v, True)
    assert out.grad_fn is None
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    np.testing.assert_array_equal(plain.numpy(), want.numpy())
    assert fa.flash_sdpa.bwd_launches == 0  # no kernel on the CPU


def test_backward_wrapper_checks_the_device_first():
    q = torch.zeros(1, 2, 8, 64, device="meta")
    lse = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention_backward(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention_lse(q, q, q)


@pytest.mark.parametrize("tq,tk,causal", [(37, 1, False), (200, 300, False), (300, 100, True),
                                          (130, 260, True), (1, 129, True)])
def test_f32_forward_tile_plan_covers_each_row_once_and_skips_only_dead_tiles(tq, tk, causal):
    bq, bk = fa.F32_BLOCK_Q, fa.F32_BLOCK_K
    plan = fa.attention_tile_plan(tq, tk, causal, bq, bk)
    rows = np.concatenate([np.arange(q0, q1) for q0, q1, _, _ in plan])
    np.testing.assert_array_equal(rows, np.arange(tq))
    for q0, q1, tiles, masked in plan:
        r = np.arange(q0, q1)[:, None]
        block_rows = np.arange(q0, q0 + bq)[:, None]
        for n in range(-(-tk // bk)):
            key = np.arange(n * bk, (n + 1) * bk)[None, :]
            assert (n < tiles) == bool(((key < tk) & ((not causal) | (key <= r))).any())
            if n < tiles:
                dead = (key >= tk) | (causal & (key > block_rows))
                assert (n in masked) == bool(dead.any())


@pytest.mark.parametrize("tq,tk,causal", [(37, 1, False), (75, 37, False), (200, 300, False),
                                          (300, 100, True), (100, 300, True), (130, 130, True),
                                          (1, 129, True)])
def test_backward_tile_plan_covers_each_pair_once_and_skips_only_dead_tiles(tq, tk, causal):
    bk, bq = fa.BWD_BLOCK_K, fa.BWD_BLOCK_Q
    plan = fa.backward_tile_plan(tq, tk, causal)
    keys = np.concatenate([np.arange(k0, k1) for k0, k1, _, _, _ in plan])
    np.testing.assert_array_equal(keys, np.arange(tk))  # every key's dk, dv written once
    for k0, k1, first, q_tiles, masked in plan:
        assert k0 % bk == 0 and 0 < k1 - k0 <= bk and q_tiles == -(-tq // bq)
        key = np.arange(k0, k0 + bk)[:, None]  # the kernel computes padded keys too
        for n in range(q_tiles):
            q = np.arange(n * bq, (n + 1) * bq)[None, :]
            live = (key < tk) & (q < tq) & ((not causal) | (key <= q))
            # visited iff some real key meets some real query it sees
            assert (n >= first) == bool(live.any()), (k0, n)
            if n >= first:  # masked iff some slot of the tile is dead
                assert (n in masked) == bool((~live).any()), (k0, n)


@pytest.mark.parametrize("tq,tk,causal", [(75, 37, False), (100, 300, True), (300, 100, True)])
def test_backward_tile_plan_reproduces_the_plain_version(tq, tk, causal):
    """The backward kernel's schedule in numpy, f64: zero-filled Q, dO, K
    and V past tq and tk, masks only on the plan's masked tiles, dk and dv
    summed per key block, dq summed over the key blocks."""
    q, k, v, g = (t[0, 0].double().numpy() for t in _inputs(6, tq, tk, torch.float32, h=1))
    bk, bq = fa.BWD_BLOCK_K, fa.BWD_BLOCK_Q
    s = q @ k.T / 8.0
    if causal:
        s = np.where(np.arange(tk)[None, :] <= np.arange(tq)[:, None], s, -np.inf)
    lse = np.log(np.exp(s - s.max(1, keepdims=True)).sum(1)) + s.max(1)
    p = np.exp(s - lse[:, None])
    delta = (g * (p @ v)).sum(1)
    n_q = -(-tq // bq)
    pad = lambda a, n: np.concatenate([a, np.zeros((n - len(a),) + a.shape[1:])])  # noqa: E731
    qp, gp, lp, dp_ = (pad(a, n_q * bq) for a in (q, g, lse, delta))
    kp, vp = (pad(a, len(fa.backward_tile_plan(tq, tk, causal)) * bk) for a in (k, v))
    dq, dk, dv = np.zeros((n_q * bq, 64)), np.zeros((tk, 64)), np.zeros((tk, 64))
    for k0, k1, first, q_tiles, masked in fa.backward_tile_plan(tq, tk, causal):
        kb, vb = kp[k0:k0 + bk], vp[k0:k0 + bk]
        dkb, dvb = np.zeros((bk, 64)), np.zeros((bk, 64))
        for n in range(first, q_tiles):
            qs = slice(n * bq, (n + 1) * bq)
            pt = np.exp(kb @ qp[qs].T / 8.0 - lp[qs][None, :])
            if n in masked:
                key = np.arange(k0, k0 + bk)[:, None]
                qq = np.arange(n * bq, (n + 1) * bq)[None, :]
                pt = np.where((key >= tk) | (qq >= tq) | (causal & (key > qq)), 0.0, pt)
            dvb += pt @ gp[qs]
            dst = pt * (vb @ gp[qs].T - dp_[qs][None, :]) / 8.0
            dkb += dst @ qp[qs]
            dq[qs] += dst.T @ kb
        dk[k0:k1], dv[k0:k1] = dkb[:k1 - k0], dvb[:k1 - k0]
    ds = p * (g @ v.T - delta[:, None]) / 8.0
    for got, want in ((dq[:tq], ds @ k), (dk, ds.T @ q), (dv, p.T @ g)):
        np.testing.assert_allclose(got, want, atol=1e-11)
