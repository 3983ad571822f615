import statistics

import numpy as np
import pytest

from perfbench import run as R
from perfbench.traffic import SAMPLE_RATE, Traffic


def mix(name):
    return R.load_files(name)[0]["traffic"]


BATCH, TURBO = mix("large-v3.batch-int8"), mix("large-v3-turbo.batch-int8")


@pytest.mark.parametrize("m", [BATCH, TURBO], ids=["large-v3", "turbo"])
def test_same_seed_same_requests_and_audio(m):
    a, b = Traffic(m, 2 ** 31 + 7), Traffic(m, 2 ** 31 + 7)
    assert [a.request(i) for i in range(300)] == [b.request(i) for i in range(300)]
    assert np.array_equal(a.bank, b.bank)
    assert np.array_equal(a.audio(a.request(5)), b.audio(b.request(5)))


@pytest.mark.parametrize("m", [BATCH, TURBO], ids=["large-v3", "turbo"])
def test_seeds_share_each_block_in_another_order(m):
    a, b = Traffic(m, 1), Traffic(m, 2)
    n = m["block"]
    ra, rb = [a.request(i) for i in range(n)], [b.request(i) for i in range(n)]
    assert [r.samples for r in ra] != [r.samples for r in rb]
    assert sorted(r.samples for r in ra) == sorted(r.samples for r in rb)
    assert sorted(map(str, (r.language for r in ra))) == sorted(map(str, (r.language for r in rb)))


def test_batch_lengths_uniform_20_to_30_s_in_english():
    t = Traffic(BATCH, 3)
    secs = [t.request(i).seconds for i in range(BATCH["block"])]
    assert 20.0 <= min(secs) and max(secs) <= 30.0
    assert statistics.mean(secs) == pytest.approx(25.0, abs=0.01)
    assert {t.request(i).language for i in range(256)} == {"en"}


def test_audio_is_a_slice_of_the_bank_of_the_stated_length():
    t = Traffic(BATCH, 5)
    for i in range(200):
        r = t.request(i)
        a = t.audio(r)
        assert a.dtype == np.int16 and len(a) == r.samples
        assert r.offset + r.samples <= len(t.bank) == BATCH["bank_s"] * SAMPLE_RATE
