"""Training in the port vs the JAX package, at f32 on the CPU (micro fixtures).

K1c (``flash_sdpa``: values and gradients, and the causal rule of its
backward), K1b's plain version (``qk_int8``: codes and outputs), the random
weights, ``loss_fn`` with every gradient leaf, ``make_batches``, the
schedule, one AdamW update, ``finetune`` and the checkpoints. The CUDA
kernels cannot run here; chip_smoke.py holds them to these plain versions
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from whisper_tpu.kernels import ops as jax_ops
from whisper_tpu.kernels.flash_attention import flash_attention as jax_flash
from whisper_tpu.kernels.flash_attention import flash_sdpa as jax_flash_sdpa
from whisper_tpu.model.load import random_model as jax_random_model
from whisper_tpu.model.params import random_params as jax_random_params
from whisper_tpu.training import finetune as jax_ft
from whisper_tpu.training import train as jax_train
from whisper_tpu_torch.kernels import flash_attention as fa
from whisper_tpu_torch.kernels import ops
from whisper_tpu_torch.model.load import random_model
from whisper_tpu_torch.model.params import random_params
from whisper_tpu_torch.training import checkpoint, finetune as ft, train

from fixtures import micro_config, write_synthetic_ggml

# flash_sdpa against JAX's and against autograd of the plain version: the
# bound tests/test_kernels.py holds JAX's flash_sdpa to XLA autodiff.
SDPA_ATOL, SDPA_RTOL = 2e-4, 1e-3
# loss_fn: f32 sums in another order on each side. Measured: the loss within
# 2e-7 relative, each gradient leaf within 1.2e-6 of its largest element;
# the bounds are ten times that.
LOSS_RTOL, GRAD_REL = 2e-6, 1e-5
# finetune's losses: one AdamW update moves an element by about ±lr whatever
# its gradient's size, so an element whose gradient is ~0 may move either way
# in the two packages and the runs drift apart at f32 noise times the lr.
FINETUNE_RTOL = 1e-4


def _qkv(seed, tq, tk, b=2, h=2, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32) for t in (tq, tk, tk)]


def _grads(fn, arrays):
    """Loss (sum of squares of fn's output) and its gradients, in torch."""
    t = [torch.from_numpy(a).requires_grad_() for a in arrays]
    loss = (fn(*t) ** 2).sum()
    loss.backward()
    return loss.item(), [x.grad.numpy() for x in t]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_sdpa_matches_jax_and_plain_autograd(causal):
    q, k, v = _qkv(11, 24, 24)
    ref_val, ref_grads = jax.value_and_grad(
        lambda q, k, v: (jax_flash_sdpa(q, k, v, causal) ** 2).sum(), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    val, grads = _grads(lambda q, k, v: fa.flash_sdpa(q, k, v, causal), (q, k, v))
    plain_val, plain_grads = _grads(
        lambda q, k, v: fa.flash_attention_reference(q, k, v, causal), (q, k, v))
    np.testing.assert_allclose(val, float(ref_val), rtol=1e-5)
    for g, r, p in zip(grads, ref_grads, plain_grads):
        np.testing.assert_allclose(g, np.asarray(r), atol=SDPA_ATOL, rtol=SDPA_RTOL)
        np.testing.assert_allclose(g, p, atol=SDPA_ATOL, rtol=SDPA_RTOL)
    assert fa.flash_attention.launches == fa.flash_attention.f32_launches == 0  # no kernel here


def test_flash_sdpa_causal_backward_takes_the_forwards_rule():
    """tq != tk: the port's backward masks key <= query from the first
    query, as the forward does, so it equals autograd of the plain version;
    JAX's backward aligns the mask at the last query (tril(k=tk - tq)) and
    so differs from both."""
    q, k, v = _qkv(12, 12, 20)
    _, grads = _grads(lambda q, k, v: fa.flash_sdpa(q, k, v, True), (q, k, v))
    _, plain = _grads(lambda q, k, v: fa.flash_attention_reference(q, k, v, True), (q, k, v))
    _, jax_grads = jax.value_and_grad(
        lambda q, k, v: (jax_flash_sdpa(q, k, v, True) ** 2).sum(), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, p, j in zip(grads, plain, jax_grads):
        np.testing.assert_allclose(g, p, atol=SDPA_ATOL, rtol=SDPA_RTOL)
    assert np.abs(grads[0] - np.asarray(jax_grads[0])).max() > 1e-2  # the expected difference


def test_flash_attention_refuses_gradients_on_the_card():
    """On a non-CPU tensor, a call that would need a backward raises before
    anything else; without grad it goes on to the device checks."""
    q = torch.zeros(1, 2, 8, 64, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_sdpa"):
        fa.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="flash_sdpa"):
        fa.flash_attention(q, q, q, qk_int8=True)
    with torch.no_grad(), pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention(q, q, q)


def test_qk_int8_codes_match_jax():
    """quantize_rows against the TPU kernel's expressions as XLA compiles
    them (jit: the division by 127 becomes a product with f32(1/127)), with
    rows that put values on rounding boundaries and an all-zero row."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, 40, 64)).astype(np.float32) * 3
    x[0, 0] = 0.0
    x[0, 1, :8] = np.float32(127.0) * np.arange(8) / 2  # halves of the scale's multiples
    x[0, 1, 8] = np.float32(127.0 * 4)

    @jax.jit
    def jax_codes(xf):  # whisper_tpu/kernels/flash_attention.py:52-55
        s = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-6) / 127.0
        return jnp.clip(jnp.round(xf / s), -127, 127).astype(jnp.int8), s

    codes, scale = fa.quantize_rows(torch.from_numpy(x))
    ref_codes, ref_scale = jax_codes(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,tk,causal", [(200, 200, False), (100, 300, False), (300, 100, True)])
def test_qk_int8_plain_version_matches_pallas_interpret(tq, tk, causal, dtype):
    """The scores are the same f32 numbers on both sides (exact int32 dot,
    the same products in the same order), so only exp and the f32 sums
    differ: 2e-6 at f32. In bf16 the probabilities round to bf16, where an
    exp an ulp apart can move one p by a bf16 ulp: 2e-3, the bf16 output's
    own resolution."""
    q, k, v = _qkv(14, tq, tk)
    jdt = getattr(jnp, dtype)
    ref = jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal, qk_int8=True,
                    interpret=True)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    ours = fa.flash_attention(*t, causal=causal, qk_int8=True)  # CPU tensor: the plain version
    assert ours.dtype == t[0].dtype
    np.testing.assert_array_equal(ours.float().numpy(),
                                  fa.flash_attention_int8_reference(*t, causal).float().numpy())
    atol = 2e-6 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32), atol=atol)
    assert fa.flash_attention.int8_launches == 0


def test_sdpa_use_flash_routes_as_jax():
    q, k, v = _qkv(15, 40, 40, d=32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for qk_int8 in (False, True):
        ref = jax_ops.sdpa(jq, jk, jv, use_flash=True, qk_int8=qk_int8)
        ours = ops.sdpa(tq, tk, tv, use_flash=True, qk_int8=qk_int8)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5)
    mask = np.random.default_rng(16).random((40, 40)) > 0.3
    ref = jax_ops.sdpa(jq, jk, jv, mask=jnp.asarray(mask), use_flash=True)
    ours = ops.sdpa(tq, tk, tv, mask=torch.from_numpy(mask), use_flash=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5)
    with pytest.raises(ValueError, match="qk_int8"):
        ops.sdpa(tq, tk, tv, mask=torch.from_numpy(mask), use_flash=True, qk_int8=True)


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], f"{prefix}{key}.")
        else:
            yield prefix + key, tree[key]


def test_random_params_bit_identical_to_jax():
    cfg = micro_config(n_vocab=51865)
    for seed in (0, 3):
        ours = dict(_leaves(random_params(cfg, seed)))
        ref = dict(_leaves(jax_random_params(cfg, seed)))
        assert ours.keys() == ref.keys()
        for name in ref:
            np.testing.assert_array_equal(ours[name], np.asarray(ref[name]), err_msg=name)


def test_random_model_on_device_draws_by_seed():
    cfg = micro_config()
    a, b = (random_model(cfg, seed=5, device="cpu") for _ in range(2))
    c = random_model(cfg, seed=6, device="cpu", dtype=torch.bfloat16)
    for (name, x), (_, y), (_, z) in zip(*(_leaves(m.params) for m in (a, b, c))):
        assert torch.equal(x, y), name
        assert z.dtype == torch.bfloat16 and z.shape == x.shape
    blocks = a.params["decoder"]["blocks"]
    assert torch.equal(blocks["attn_ln_w"], torch.ones_like(blocks["attn_ln_w"]))
    assert not blocks["q_b"].any()
    assert abs(blocks["mlp0_w"].std().item() - 0.02) < 1e-3
    host = random_model(cfg, seed=5, device="cpu", on_device=False)
    for (name, x), (_, r) in zip(_leaves(host.params), _leaves(jax_random_params(cfg, 5))):
        np.testing.assert_array_equal(x.numpy(), np.asarray(r), err_msg=name)


@pytest.fixture(scope="module")
def models():
    """The micro model in both packages, the same numpy weights."""
    cfg = micro_config(n_vocab=51865)
    return (jax_random_model(cfg, seed=3, on_device=False),
            random_model(cfg, seed=3, device="cpu", on_device=False))


def _pairs(n, seed=0):
    rng = np.random.default_rng(seed)
    texts = ["hello there", "general kenobi", "testing one two", "whisper on tpu"]
    return [(rng.standard_normal(16000 * 2).astype(np.float32) * 0.1, texts[i % len(texts)])
            for i in range(n)]


def test_loss_and_every_gradient_leaf_match_jax(models):
    jax_model, model = models
    cfg = model.config
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    tokens = rng.integers(0, cfg.n_vocab, (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), np.int32)
    mask[1, 20:] = 0
    ref_loss, ref_grads = jax.value_and_grad(jax_train.loss_fn)(
        jax_model.params, jnp.asarray(mel), jnp.asarray(tokens), jnp.asarray(mask), cfg)
    params = train.init_train_state(model.params, train.make_optimizer()).params
    loss = train.loss_fn(params, torch.from_numpy(mel), torch.from_numpy(tokens).long(),
                         torch.from_numpy(mask), cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    ref = dict(_leaves(ref_grads))
    for name, leaf in _leaves(params):
        r = np.asarray(ref[name])
        assert leaf.grad is not None and leaf.grad.abs().max() > 0, name
        err = np.abs(leaf.grad.numpy() - r).max()
        assert err <= GRAD_REL * np.abs(r).max(), (name, err, np.abs(r).max())


def test_make_batches_match_jax(models):
    jax_model, model = models
    pairs = _pairs(6)
    ours = ft.make_batches(model, pairs, batch_size=2, seed=4)
    ref = jax_ft.make_batches(jax_model, pairs, batch_size=2, seed=4)
    for _ in range(4):  # past the first epoch's reshuffle
        (mel, tok, mask), (rmel, rtok, rmask) = next(ours), next(ref)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
        np.testing.assert_allclose(mel.numpy(), np.asarray(rmel), atol=2e-4)
        assert tok.shape[1] % 32 == 0


@pytest.mark.parametrize("lr,warmup,steps", [(3e-4, 1, 6), (1e-5, 10, 100), (1e-4, 0, 5),
                                             (2e-4, 20, 4)])
def test_schedule_matches_optax_at_every_step(lr, warmup, steps):
    ours = ft.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=warmup,
                                             decay_steps=max(steps, warmup + 1))
    for count in range(max(steps, warmup + 1) + 3):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6, atol=1e-12)
    assert ours(0) == (0.0 if warmup else lr)  # a warm-up starts from 0


FT = dict(steps=6, batch_size=2, lr=3e-4, warmup=1)


@pytest.fixture(scope="module")
def jax_finetune(models):
    """JAX's finetune loop (whisper_tpu/training/finetune.py:115-124), step
    by step: the losses, and the params after step 2 (the first update with
    a learning rate above 0)."""
    jax_model, _ = models
    steps, warmup, lr = FT["steps"], FT["warmup"], FT["lr"]
    schedule = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=warmup,
                                                  decay_steps=max(steps, warmup + 1))
    optimizer = optax.adamw(schedule, weight_decay=0.01)
    state = jax_train.init_train_state(jax_model.params, optimizer)
    step_fn = jax_train.make_train_step(jax_model.config, optimizer)
    batches = jax_ft.make_batches(jax_model, _pairs(4), FT["batch_size"], "en", seed=0)
    losses, after_two = [], None
    for i in range(steps):
        state, loss = step_fn(state, *next(batches))
        losses.append(float(loss))
        if i == 1:
            after_two = jax.tree.map(np.asarray, state.params)
    return losses, after_two


def test_finetune_tracks_jax_and_reduces_eval_loss(models, jax_finetune, monkeypatch):
    _, model = models
    ref_losses, ref_after_two = jax_finetune
    losses, after_two = [], {}
    real = ft.make_train_step

    def spy(cfg, optimizer):
        step_fn = real(cfg, optimizer)

        def wrapped(state, *batch):
            state, loss = step_fn(state, *batch)
            losses.append(loss.item())
            if state.step == 2:
                after_two.update((k, v.detach().clone()) for k, v in _leaves(state.params))
            return state, loss
        return wrapped

    monkeypatch.setattr(ft, "make_train_step", spy)
    pairs = _pairs(4)
    before = ft.evaluate(model, model.params, pairs, batch_size=2, language="en")
    state = ft.finetune(model, pairs, log_every=100, **FT)
    after = ft.evaluate(model, state.params, pairs, batch_size=2, language="en")
    assert after < before, (before, after)
    assert state.step == 6
    np.testing.assert_allclose(losses, ref_losses, rtol=FINETUNE_RTOL)
    # One AdamW update (step 2, lr = schedule(1) = 3e-4): an element moves by
    # lr · m̂/(sqrt(v̂) + eps) ≈ ±lr, so it agrees with JAX's to f32 noise,
    # except where the gradient is ~0 and its sign differs: at most 2 lr there.
    lr = ft.warmup_cosine_decay_schedule(0.0, FT["lr"], 1, 6)(1)
    moved = total = 0
    for name, ref in _leaves(ref_after_two):
        diff = np.abs(after_two[name].numpy() - ref)
        assert diff.max() <= 2 * lr * 1.001, (name, diff.max())
        moved += int((diff > 1e-3 * lr).sum())
        total += diff.size
    assert moved / total < 1e-3, moved / total


def test_train_state_checkpoint_resumes_bit_identically(models, tmp_path):
    _, model = models
    optimizer = train.make_optimizer(ft.warmup_cosine_decay_schedule(0.0, 3e-4, 1, 6))
    step_fn = train.make_train_step(model.config, optimizer)

    def run(state, n):
        batches = ft.make_batches(model, _pairs(4), 2, seed=state.step)
        losses = []
        for _ in range(n):
            state, loss = step_fn(state, *next(batches))
            losses.append(loss.item())
        return state, losses

    state, _ = run(train.init_train_state(model.params, optimizer), 2)
    checkpoint.save_train_state(str(tmp_path / "ckpt" / "step_2.pt"), state)
    done, losses = run(state, 2)
    template = train.init_train_state(model.params, optimizer)
    resumed = checkpoint.restore_train_state(str(tmp_path / "ckpt" / "step_2.pt"), template)
    assert resumed.step == 2
    again, losses_again = run(resumed, 2)
    assert losses_again == losses
    for (name, x), (_, y) in zip(_leaves(done.params), _leaves(again.params)):
        assert torch.equal(x, y), name
    moments = [s["exp_avg_sq"] for s in again.opt_state.state.values()]
    assert all(torch.equal(a["exp_avg_sq"], b) for a, b in
               zip(done.opt_state.state.values(), moments))

    checkpoint.save_params(str(tmp_path / "params.pt"), done.params)
    restored = checkpoint.restore_params(str(tmp_path / "params.pt"))
    for (name, x), (_, y) in zip(_leaves(done.params), _leaves(restored)):
        assert torch.equal(x.detach(), y) and not y.requires_grad, name


def test_cached_load_round_trips(tmp_path):
    cfg = micro_config()
    path = tmp_path / "micro.bin"
    write_synthetic_ggml(path, cfg, seed=9)
    first = checkpoint.cached_load(str(path), cache_dir=str(tmp_path / "cache"), device="cpu")
    cached = list((tmp_path / "cache").iterdir())
    assert len(cached) == 2  # the params file and its metadata
    second = checkpoint.cached_load(str(path), cache_dir=str(tmp_path / "cache"), device="cpu")
    assert second.config == first.config
    assert second.vocab.id_to_token == first.vocab.id_to_token
    assert torch.equal(second.filters, first.filters)
    for (name, x), (_, y) in zip(_leaves(first.params), _leaves(second.params)):
        assert torch.equal(x, y), name


def test_finetune_refuses_a_mesh(models):
    with pytest.raises(NotImplementedError, match="mesh"):
        ft.finetune(models[1], _pairs(2), steps=1, batch_size=2, mesh=object())
