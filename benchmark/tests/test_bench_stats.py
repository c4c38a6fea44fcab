"""The window rule and the interval arithmetic on synthetic data."""

import pytest

from benchmark import stats


def _lockstep(users, period, n, start=0.0, jitter=0.0):
    """Closed-loop iterations of ``users`` users, all ending within
    ``jitter`` of each other: completions in clusters."""
    out = []
    for u in range(users):
        t = start + u * jitter
        for e in range(n):
            out.append({"user": u, "epoch": e, "t0": t, "t1": t + period})
            t += period
    return out


@pytest.mark.parametrize("t0", [0.0, 3.0, 9.99, 10.0, 17.5])
def test_window_rule_does_not_depend_on_the_edges(t0):
    iters = _lockstep(4, 10.0, 20, jitter=0.01)
    count, mean = stats.window_iterations(iters, t0, t0 + 30.0)
    # four users at one iteration a 10 s: 12 in 30 s wherever it starts,
    # where counting the completions inside would give 8, 12 or 16
    assert count == pytest.approx(12.0, abs=0.01)
    assert mean == pytest.approx(10.0)


def test_window_rule_weights_each_iteration_by_its_share():
    iters = [{"user": 0, "epoch": 0, "t0": 0.0, "t1": 4.0},
             {"user": 0, "epoch": 1, "t0": 4.0, "t1": 12.0},
             {"user": 0, "epoch": -1, "t0": 12.0, "t1": 13.0},
             {"user": 0, "epoch": 2, "t0": 13.0, "t1": None}]
    count, mean = stats.window_iterations(iters, 2.0, 10.0)
    # half of the first (2 of 4 s), three quarters of the second (6 of 8)
    assert count == pytest.approx(0.5 + 0.75)
    assert mean == pytest.approx((0.5 * 4 + 0.75 * 8) / 1.25)
    assert stats.window_iterations(iters, 20.0, 30.0) == (0.0, None)


def test_busy_gaps_and_overlap():
    dev = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0), (9.0, 12.0)]
    assert stats.union(dev) == [[1.0, 3.0], [5.0, 6.0], [9.0, 12.0]]
    assert stats.busy(dev, 0.0, 10.0) == pytest.approx(4.0)
    assert stats.gaps(dev, 0.0, 10.0) == [(0.0, 1.0), (3.0, 5.0),
                                          (6.0, 9.0)]
    host = [(2.5, 5.5)]
    # device busy 1-3, 5-6, 9-12 (6 s); host covers 2.5-3 and 5-5.5
    assert stats.overlap_share(dev, host) == pytest.approx(1.0 / 6.0)
    assert stats.overlap_share(dev, []) is None
    assert stats.overlap_share([], host) is None


def test_spread_is_python_quartiles_over_the_median():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    import statistics

    q1, _, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / 12.5)
