"""Percentiles, with unserved requests in the tail."""
import numpy as np
import pytest

from perfbench.lib.stats import latencies_with_unserved, percentile


def test_percentile_matches_numpy_linear():
    rng = np.random.default_rng(0)
    xs = rng.exponential(size=337).tolist()
    for q in (50, 95, 99):
        assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_a_stall_moves_the_p95():
    due = [i * 0.1 for i in range(100)]
    done = [t + 0.05 for t in due]
    base = percentile(latencies_with_unserved(done, due, 10.0), 95)
    # a stall at 8 s: nothing after it is served by the window's end
    stalled = [d if t < 8.0 else None for d, t in zip(done, due)]
    lat = latencies_with_unserved(stalled, due, 10.0)
    assert len(lat) == 100
    assert percentile(lat, 95) > 10 * base
    # served after the end counts as the end
    late = [d if t < 8.0 else 99.0 for d, t in zip(done, due)]
    assert latencies_with_unserved(late, due, 10.0) == lat


def test_requests_due_after_the_end_are_not_counted():
    assert latencies_with_unserved([1.0, None], [0.5, 10.5], 10.0) == [0.5]
