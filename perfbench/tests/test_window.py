import pytest

from perfbench.cell import bursts, cycle_window


def cycles(n, period=10.0, groups=((0.0, 33), (2.0, 16), (4.0, 8), (6.0, 7))):
    """Resolution times of slot groups finishing once a cycle, each at its own phase."""
    return [c * period + phase + i * 0.001 for c in range(n) for phase, size in groups
            for i in range(size)]


def test_bursts_group_close_resolutions():
    b = bursts([0.0, 0.01, 0.02, 1.0, 1.01, 5.0])
    assert [size for _end, size in b] == [3, 2, 1]
    assert b[0][0] == pytest.approx(0.02)


def test_the_window_spans_whole_cycles_whatever_its_start():
    times = cycles(8)
    for start in (0.5, 2.5, 5.5, 7.9):
        t_open, t_close = cycle_window(times, start, 40.0, 64)
        span = t_close - t_open
        assert span == pytest.approx(round(span / 10.0) * 10.0, abs=0.01)
        inside = [t for t in times if t_open < t <= t_close]
        assert len(inside) == 64 * round(span / 10.0)


def test_without_a_recurring_big_group_any_two_bursts():
    times = cycles(8, groups=((0.0, 10), (5.0, 10)))
    t_open, t_close = cycle_window(times, 1.0, 30.0, 64)
    assert t_open < t_close


def test_too_short_a_window_raises():
    with pytest.raises(RuntimeError):
        cycle_window(cycles(1), 0.5, 1.0, 64)
