"""The percentile, spread, rate and interval arithmetic."""

import statistics

import numpy as np
import pytest

from harness import stats


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_percentile_matches_numpy(q):
    rng = np.random.default_rng(3)
    xs = list(rng.exponential(size=401))
    assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_percentile_of_every_value_counts_the_tail():
    xs = [1.0] * 95 + [100.0] * 5
    assert stats.percentile(xs, 95) == pytest.approx(1.0 + 99.0 * 0.05)
    assert stats.percentile(xs, 96) > 1.0


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / statistics.median(xs))


def test_rate_over_the_whole_window():
    assert stats.rate(300, 10.0) == 30.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_of_overlapping_intervals_is_clipped_to_the_window():
    iv = [(0, 4), (2, 6), (8, 9), (12, 20)]
    assert stats.union_seconds(iv, 1, 15) == (6 - 1) + 1 + (15 - 12)
    assert stats.union_seconds([], 0, 5) == 0
