"""The decode kernels' plain versions against the JAX package's Pallas
kernels on the CPU: K5 (``cached_attention``, interpret mode), K6
(``permute_rows_multi``, interpret mode) and K7 (``cow_copy_rows``, its
CPU route). On CPU tensors the port's wrappers take these plain versions
and launch nothing; chip_smoke.py holds the CUDA kernels to them on the card.

Tolerances: K5 at f32 within 1e-5 (both take f32 scores, softmax and PV
sums; only the order of the sums differs, over at most 40 keys of unit-scale
inputs); K6 and K7 copy bytes, so exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.decoding.device_beam import cow_assign as jax_cow_assign
from whisper_tpu.kernels.beam_gather import cow_copy_rows as jax_cow_copy_rows
from whisper_tpu.kernels.beam_gather import permute_rows_multi as jax_permute_rows_multi
from whisper_tpu.kernels.decode_attention import cached_attention as jax_cached_attention
from whisper_tpu_torch.kernels import beam_gather as bg
from whisper_tpu_torch.kernels import decode_attention as k5
from whisper_tpu_torch.kernels.decode_attention import (cached_attention,
                                                        cached_attention_reference)
from whisper_tpu_torch.model.decoder import KVCache
from whisper_tpu_torch.model.quant import QuantKV


@pytest.mark.parametrize("T,n_past", [(1, 0), (1, 21), (3, 9), (32, 0)])
def test_cached_attention_matches_pallas_interpret(T, n_past):
    """One layer of the port's (B, L, H, D, C) cache, read in place; JAX's
    kernel takes the same cache transposed to (L, B, H, D, C)."""
    rng = np.random.default_rng(T * 100 + n_past)
    B, L, H, D, C, layer = 3, 2, 2, 32, 40, 1
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, L, H, D, C)).astype(np.float32) for _ in range(2))
    ref = jax_cached_attention(jnp.asarray(q), jnp.asarray(ck.transpose(1, 0, 2, 3, 4)),
                               jnp.asarray(cv.transpose(1, 0, 2, 3, 4)), layer, n_past,
                               interpret=True)
    tk, tv = torch.from_numpy(ck), torch.from_numpy(cv)
    launches = cached_attention.launches
    out = cached_attention(torch.from_numpy(q), tk[:, layer], tv[:, layer], n_past)
    assert cached_attention.launches == launches  # CPU: the plain version
    assert out.dtype == torch.float32 and out.shape == (B, H, T, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_cached_attention_rounds_p_to_the_cache_dtype():
    """bf16 cache: the normalised probabilities round to bf16 before the PV
    sum, as the JAX decoder's _kvmajor_sdpa does (the Pallas kernel keeps
    them in f32); the output takes q's dtype."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 2, 1, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 32, 24)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2))
    out = cached_attention_reference(q, k, v, n_past=17)
    logits = torch.matmul(q, k.float()) * 32 ** -0.5
    logits[..., 18:] = -1e30
    p = torch.softmax(logits, dim=-1).to(torch.bfloat16).float()
    torch.testing.assert_close(out, torch.matmul(p, v.float().transpose(-1, -2)),
                               atol=0, rtol=0)
    assert cached_attention_reference(q.to(torch.bfloat16), k, v, 17).dtype == torch.bfloat16


def _check_tile(head: int, C: int, c0: int, n: int, esz: int, pitch: int) -> None:
    """Each of the head's 64 rows: the copies of keys [c0, c0 + n) are
    disjoint, cover every byte of those keys once, land at the byte's offset
    from the row's 16-byte aligned start within ``pitch``, read nothing
    outside the head (64 rows of C elements from ``head``), and the 16-byte
    ones are aligned at both ends."""
    lo, hi = head, head + 64 * C * esz
    for d in range(64):
        a = lo + (d * C + c0) * esz
        e = a + n * esz
        pieces = sorted(k5.tile_pieces(head, C, c0, n, esz, d))
        covered, end = 0, None
        for src, size, dst, kind in pieces:
            assert lo <= src and src + size <= hi, "a copy reads outside the head"
            assert end is None or src >= end, "two copies overlap"
            assert dst == src - (a & ~15) and 0 <= dst and dst + size <= pitch
            if kind == "async":
                assert size == 16 and src % 16 == 0 and dst % 16 == 0
            else:
                assert size == esz and a <= src < e  # an element the tile needs
            covered += max(0, min(src + size, e) - max(src, a))
            end = src + size
        assert covered == e - a


@pytest.mark.parametrize("esz", [2, 4])  # a bf16 or an f32 cache
@pytest.mark.parametrize("past", ["0", "40", "C-1"])
@pytest.mark.parametrize("T", [1, 3, 32])
@pytest.mark.parametrize("C", [1, 75, 104, 448])
def test_cached_attention_plan_covers_every_row_and_visible_key(C, T, past, esz):
    """K5's launch (csrc/decode_attention.cu follows the same plan): every
    query row of every (b, h) falls in one block; each block's K and V tiles
    cover the keys its rows can see once, and each tile's copies bring every
    byte of those keys once and read nothing past the head, also when the
    cache's base is not 16-byte aligned (rows of C = 75 are not either)."""
    n_past = {"0": 0, "40": 40, "C-1": C - 1}[past]
    plan = k5.cached_attention_plan(C, T, n_past, esz)
    assert plan.rows in (1, 2, 4, 8) and plan.smem <= k5.SMEM_MAX
    blocks = [rb * plan.rows + r for rb in range(plan.row_blocks) for r in range(plan.rows)]
    assert [t for t in blocks if t < T] == list(range(T))
    assert plan.row_blocks * plan.rows - T < plan.rows
    B, L, H, layer = 2, 2, 2, 1  # heads of layer 1 of a (B, L, H, 64, C) cache
    for off in sorted({0, esz, 14 // esz * esz}):  # the cache's base from an aligned one
        for b, h in ((0, 0), (B - 1, H - 1)):
            head = 4096 + off + ((b * L + layer) * H + h) * 64 * C * esz
            for rb in range(plan.row_blocks):
                c_hi = min(C, n_past + min((rb + 1) * plan.rows, T))
                tiles = [(c0, min(plan.width, c_hi - c0)) for c0 in range(0, c_hi, plan.width)]
                assert [c for c0, n in tiles for c in range(c0, c0 + n)] == list(range(c_hi))
                for c0, n in tiles:
                    _check_tile(head, C, c0, n, esz, plan.pitch)


def test_cached_attention_plan_tiles_and_refuses_what_does_not_fit():
    """K and V of every visible key fit at once at the main paths' shapes;
    an f32 cache over all 448 positions takes tiles of a multiple of 16
    keys; a call whose logits pass the shared memory raises."""
    assert k5.cached_attention_plan(104, 1, 40, 2).width == 41
    assert k5.cached_attention_plan(448, 1, 40, 2).width == 41
    assert k5.cached_attention_plan(448, 1, 447, 2).width == 448
    plan = k5.cached_attention_plan(448, 1, 447, 4)
    assert plan.width < 448 and plan.width % 16 == 0 and plan.smem <= k5.SMEM_MAX
    assert k5.cached_attention_plan(104, 32, 0, 2).rows == 8
    assert k5.cached_attention_plan(60_000, 1, 0, 2).width == 1  # only key 0 is visible
    with pytest.raises(ValueError, match="at most"):
        k5.cached_attention_plan(60_000, 1, 59_999, 2)


def _cache_leaves(rng, B: int):
    """int8 codes (B, L, H, D, C), f32 scales (B, L, H, C) and a float leaf
    of another trailing shape (JAX's kernel needs the leaves to share L)."""
    return [rng.integers(-127, 128, size=(B, 2, 2, 8, 5)).astype(np.int8),
            rng.random((B, 2, 2, 5)).astype(np.float32),
            rng.standard_normal((B, 2, 4, 3)).astype(np.float32)]


def test_permute_rows_multi_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    B = 6
    leaves = _cache_leaves(rng, B)
    rows = np.array([3, 3, 0, 5, 1, 3])  # repeated sources
    ref = jax_permute_rows_multi(
        [jnp.asarray(leaves[0]), jnp.asarray(leaves[1]), jnp.asarray(leaves[2], jnp.bfloat16)],
        jnp.asarray(rows, jnp.int32), interpret=True)
    tl = [torch.from_numpy(leaves[0]), torch.from_numpy(leaves[1]),
          torch.from_numpy(leaves[2]).to(torch.bfloat16)]
    out = bg.permute_rows_multi(tl, torch.from_numpy(rows))
    assert bg.permute_rows_multi.launches == 0
    for o, r, a in zip(out, ref, tl):
        assert o.dtype == a.dtype and o.shape == a.shape
        np.testing.assert_array_equal(o.float().numpy(), np.asarray(r, np.float32))
    np.testing.assert_array_equal(bg.permute_rows(tl[0], torch.from_numpy(rows)).numpy(),
                                  np.asarray(ref[0]))


def test_permute_cache_rows_keeps_the_cache_structure():
    rng = np.random.default_rng(1)
    codes, scales, _ = _cache_leaves(rng, 4)
    cache = KVCache(QuantKV(torch.from_numpy(codes), torch.from_numpy(scales)),
                    QuantKV(torch.from_numpy(-codes), torch.from_numpy(2 * scales)))
    rows = torch.tensor([2, 2, 1, 0])
    out = bg.permute_cache_rows(cache, rows)
    assert isinstance(out, KVCache) and isinstance(out.v, QuantKV)
    torch.testing.assert_close(out.v.data, cache.v.data[rows])
    torch.testing.assert_close(out.k.scale, cache.k.scale[rows])
    flat = KVCache(torch.from_numpy(scales), torch.from_numpy(3 * scales))
    torch.testing.assert_close(bg.permute_cache_rows(flat, rows).v, flat.v[rows])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cow_copy_rows_matches_jax_in_place(seed):
    """A ``src`` made by JAX's cow_assign from random beam sources: the
    plain version equals JAX's cow_copy_rows (its CPU route, a gather), and
    writes into the leaves it was given."""
    rng = np.random.default_rng(seed)
    G, k = 3, 4
    phys = np.stack([rng.permutation(k) for _ in range(G)]).astype(np.int32)
    new_src = rng.integers(0, k, size=(G, k)).astype(np.int32)
    _, copy_src = jax_cow_assign(jnp.asarray(phys), jnp.asarray(new_src), k)
    src = (np.asarray(copy_src) + (np.arange(G) * k)[:, None]).reshape(-1)
    assert (src != np.arange(G * k)).any()
    leaves = _cache_leaves(rng, G * k)[:2]
    ref = jax_cow_copy_rows(tuple(jnp.asarray(a) for a in leaves), jnp.asarray(src, jnp.int32))
    tl = [torch.from_numpy(a.copy()) for a in leaves]
    ptrs = [a.data_ptr() for a in tl]
    out = bg.cow_copy_rows(tl, torch.from_numpy(src))
    assert bg.cow_copy_rows.launches == 0
    assert [a.data_ptr() for a in out] == ptrs
    for a, r in zip(tl, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_cow_copy_rows_reference_refuses_a_source_that_is_a_destination():
    a = torch.arange(12.0).reshape(4, 3)
    with pytest.raises(ValueError, match="destination"):
        bg.cow_copy_rows([a], torch.tensor([0, 0, 1, 3]))  # row 1 is read and written
    bg.cow_copy_rows([a], torch.tensor([0, 0, 2, 2]))
    torch.testing.assert_close(a[1], a[0])
    torch.testing.assert_close(a[3], a[2])


@pytest.mark.parametrize("wrapper", ["permute_rows_multi", "cow_copy_rows"])
def test_row_copies_refuse_an_index_on_another_device(wrapper):
    """The route follows the leaves' device: an index on the CPU beside
    leaves elsewhere (here the meta device, standing for the card) raises
    and does not fall back to the plain version."""
    fn = getattr(bg, wrapper)
    idx = torch.tensor([0, 0, 2, 3])
    with pytest.raises(ValueError, match="first leaf on meta"):
        fn([torch.empty(4, 3, device="meta")], idx)
    with pytest.raises(ValueError, match="first leaf on cpu"):
        fn([torch.zeros(4, 3)], idx.to("meta"))
    assert fn.launches == 0


# Row sizes of the two smoke shapes (int8 codes / f32 scales of the 160-row
# cache, the host beam's bf16 K/V pair) and the same sizes knocked off 16.
INT8_ROW, SCALE_ROW, BF16_ROW = 32 * 20 * 64 * 75, 4 * 32 * 20 * 75, 2 * 32 * 20 * 64 * 448


@pytest.mark.parametrize("row_bytes,n_rows", [
    ([INT8_ROW, SCALE_ROW, INT8_ROW, SCALE_ROW], 160),
    ([INT8_ROW + 5, SCALE_ROW + 3, INT8_ROW - 7, 9], 160),
    ([BF16_ROW, BF16_ROW], 20),
    ([BF16_ROW + 1, BF16_ROW - 15], 20),
    ([0, 33, 16], 3),
])
def test_copy_plan_covers_each_output_byte_once_in_real_pieces(row_bytes, n_rows):
    first = bg.copy_plan(row_bytes, n_rows)
    pieces = list(bg.plan_pieces(row_bytes, n_rows))
    assert len(pieces) == first[-1]
    spans = {}
    for z, j, c0, c1 in pieces:
        assert 0 <= c0 < c1 <= row_bytes[z] and c1 - c0 <= bg.CHUNK_BYTES  # no empty piece
        spans.setdefault((z, j), []).append((c0, c1))
    for z, rb in enumerate(row_bytes):
        for j in range(n_rows):
            end = 0
            for c0, c1 in sorted(spans.get((z, j), [])):
                assert c0 == end  # no gap, no overlap
                end = c1
            assert end == rb
    # the rows of one (leaf, chunk) are adjacent blocks, in row order
    for b in range(0, len(pieces), n_rows):
        group = pieces[b:b + n_rows]
        assert len({(z, c0) for z, _, c0, _ in group}) == 1
        assert [j for _, j, _, _ in group] == list(range(n_rows))


@pytest.mark.parametrize("seed", [0, 1])
def test_copy_plan_run_on_the_host_gathers_and_forks_like_the_plain_versions(seed, monkeypatch):
    """Both kernels' loops, run over bytes in numpy with a 16-byte chunk:
    the gather equals index_select, the fork copy the plain cow_copy_rows."""
    monkeypatch.setattr(bg, "CHUNK_BYTES", 16)
    rng = np.random.default_rng(seed)
    leaves = [rng.integers(-127, 128, size=(6, 3, 7)).astype(np.int8),
              rng.random((6, 5)).astype(np.float32), rng.random((6, 2, 3)).astype(np.float64)]
    row_bytes = [a[0].nbytes for a in leaves]
    rows = np.array([3, 3, 0, 5, 1, 3])
    flat = [a.reshape(6, -1).view(np.uint8) for a in leaves]
    outs = [np.zeros_like(f) for f in flat]
    for z, j, c0, c1 in bg.plan_pieces(row_bytes, 6):
        outs[z][j, c0:c1] = flat[z][rows[j], c0:c1]
    want = bg.permute_rows_reference([torch.from_numpy(a) for a in leaves], torch.from_numpy(rows))
    for o, w, a in zip(outs, want, leaves):
        np.testing.assert_array_equal(o.view(a.dtype).reshape(a.shape), w.numpy())
    src = np.array([0, 0, 2, 2, 4, 0])  # rows 1, 3, 5 fork from 0, 2, 0
    forked = [f.copy() for f in flat]
    for z, i, c0, c1 in bg.plan_pieces(row_bytes, 6):
        if src[i] != i:
            forked[z][i, c0:c1] = forked[z][src[i], c0:c1]
    want = bg.cow_copy_rows_reference([torch.from_numpy(a.copy()) for a in leaves],
                                      torch.from_numpy(src))
    for o, w, a in zip(forked, want, leaves):
        np.testing.assert_array_equal(o.view(a.dtype).reshape(a.shape), w.numpy())
