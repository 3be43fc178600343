"""Rates and percentiles are taken over the whole window and every frame."""

import pytest

from streambench import stats


def test_rate_counts_the_window_not_first_to_last():
    # 10 frames at 10/s, then a stall to the window's end
    times = [0.1 * i for i in range(10)]
    assert stats.window_rate(times, 0.0, 4.0) == pytest.approx(2.5)
    # a stall at the start: the same 10 frames late in the window
    late = [3.0 + 0.1 * i for i in range(10)]
    assert stats.window_rate(late, 0.0, 4.0) == pytest.approx(2.5)


def test_rate_edges():
    times = [0.0, 1.0, 2.0]
    assert stats.window_rate(times, 0.0, 2.0) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        stats.window_rate(times, 1.0, 1.0)


def test_percentile_is_nearest_rank_over_every_value():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals, 100) == 100
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([], 95) is None
    # one slow frame in twenty is the 95th percentile's edge
    assert stats.percentile([10.0] * 19 + [500.0], 95) == 10.0
    assert stats.percentile([10.0] * 18 + [500.0] * 2, 95) == 500.0


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.gaps(iv, 0.0, 5.0) == [[2.0, 3.0], [4.0, 5.0]]
    assert stats.union_length([]) == 0.0
