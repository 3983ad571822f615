import pytest

from perfbench import families, flops, layers, roofline
from perfbench import run as R

LARGE = families.load("whisper").dims(R.load_cell("large-v3.batch-int8", R.load_spec())[2])


def test_k1_bound_at_sixteen_windows_is_perf_md_s_0_1864_ms():
    # (320, 1500, 64): 16 windows x 20 heads; operation bound
    f, b = flops.k1_flops(320, 1500, 1500, 64), flops.k1_bytes(320, 1500, 1500, 64)
    assert f == 4 * 320 * 1500 * 1500 * 64
    assert roofline.bound_s(f, b) * 1e3 == pytest.approx(0.1864, abs=5e-5)
    assert f / roofline.PEAK_BF16_FLOPS > b / roofline.PEAK_BYTES


def test_k4_cross_bound_at_the_engine_pool_is_perf_md_s_0_0793_ms():
    # q (65, 20, 1, 64) over 1500 int8 positions; byte bound
    b = flops.k4_bytes(65, 20, 1, 64, 1500)
    assert b == 2 * 65 * 20 * 1500 * 64 + 2 * 65 * 20 * 1500 * 4 + 2 * 2 * 65 * 20 * 64
    bound = roofline.bound_s(flops.k4_flops(65, 20, 1, 64, 1500), b)
    assert bound * 1e3 == pytest.approx(0.0793, abs=5e-5)


def test_large_v3_window_against_a_hand_count():
    a, T = 1280, 1500
    stem = 2 * 3000 * 128 * 3 * a + 2 * T * a * 3 * a
    layer = 2 * T * a * a * 4 + 2 * T * a * 4 * a * 2 + 4 * T * T * a
    cross = 32 * 2 * (2 * T * a * a)
    encoder = stem + 32 * layer + cross
    assert flops.encoder_flops(LARGE) == pytest.approx(encoder, rel=1e-12)
    assert encoder == pytest.approx(2.588e12, rel=1e-3)

    def token(p, logits):
        per = 2 * a * 3 * a + 2 * a * a + 2 * a * a + 2 * a * a + 2 * 2 * a * 4 * a
        per += 2 * 2 * (p + 1) * a + 2 * 2 * T * a
        return 32 * per + (2 * a * 51866 if logits else 0)

    hand = encoder + sum(token(p, p == 2) for p in range(3))
    hand += sum(token(3 + i, True) for i in range(96))
    assert flops.window_flops(LARGE, 3, 96) == pytest.approx(hand, rel=1e-12)
    # the issue's reckoning: ~2.5 TFLOP a window, ~2 GFLOP a decoded token
    assert 2.5e12 < hand < 2.9e12


def test_mfu_of_one_window_a_second():
    seg = {"seek": 0, "tokens": list(range(96))}
    done = [{"result": {"segments": [seg]}}]
    rec = {"dims": LARGE, "window_s": 1.0, "done": done,
           "host": {"window_s": 0.5, "done": [], "stats": {}}}
    expect = 100 * flops.window_flops(LARGE, 3, 96) / 989e12
    assert layers.mfu(rec) == pytest.approx(expect, rel=1e-12)
    assert 0.25 < expect < 0.3


def test_readers_find_nothing_to_read_in_an_empty_record():
    cell = R.load_cell("large-v3.batch-int8", R.load_spec())[1]
    rec = {"window_s": 1.0, "dims": LARGE, "cell": cell, "done": [], "stats": {}, "launches": {},
           "host": {"window_s": 1.0, "done": [], "stats": {}}}
    for fn in (layers.admit_share, layers.step_ms, layers.idle_share,
               layers.mfu, layers.k1_roofline, layers.k4_roofline):
        assert fn(rec) is None
    rec["trace"] = {"window_s": 1.0, "busy_s": 0.0, "n_kernels": 0, "kernel_s": {}, "kernel_n": {},
                    "stats": {}, "launches": {}}
    assert layers.idle_share(rec) is None and layers.k1_roofline(rec) is None


K1 = "(anonymous namespace)::attention_bf16_kernel(CUtensorMap_st, float*, int)"
K4D = "void (anonymous namespace)::attention_int8_kernel<__nv_bfloat16, 1>(signed char const*)"
K4P = "void (anonymous namespace)::attention_int8_kernel<__nv_bfloat16, 8>(signed char const*)"


def test_kernel_shares_from_the_trace_s_own_launches():
    """A sixteen-window bucket through 32 layers at PERF.md's K1 time gives
    its share, and the same launches with four of the rows padding give
    three quarters of it; decode launches (cross and self alike) at the
    65-row engine's cross time give K4's."""
    cell = R.load_cell("large-v3.batch-int8", R.load_spec())[1]
    cell = dict(cell, engine=dict(cell["engine"], slots=64))
    tr = {"kernel_s": {K1: 32 * 0.3961e-3, K4D: 64 * 0.1469e-3 + 64 * 1e-6, K4P: 0.0},
          "kernel_n": {K1: 32, K4D: 128, K4P: 0}, "encode_windows": 16, "encode_buckets": 1}
    rec = {"trace": tr, "dims": LARGE, "cell": cell, "done": []}
    assert layers.k1_roofline(rec) == pytest.approx(100 * 0.1864 / 0.3961, rel=1e-3)
    # no resolved windows: the self launches count only q and out
    self_b = flops.k4_bytes(65, 20, 1, 64, 0)
    expect = 100 * (0.0793e-3 + self_b / 3.35e12) / (0.1469e-3 + 1e-6)
    assert layers.k4_roofline(rec) == pytest.approx(expect, rel=1e-3)
    tr["encode_windows"] = 12
    assert layers.k1_roofline(rec) == pytest.approx(75 * 0.1864 / 0.3961, rel=1e-3)
    tr["encode_windows"] = tr["encode_buckets"] = 0
    assert layers.k1_roofline(rec) is None
