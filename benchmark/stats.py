"""Window statistics and interval arithmetic.

**The window rule.**  A cohort's iterations last seconds and finish in
clusters (the scheduler stacks the users' device steps, so they move in
step), so counting the iterations that end inside the window would read
high or low by as much as a cohort round, depending on where the edges
fall.  Instead every iteration that overlaps the window counts with the
share of its own length that lies inside it: ``iterations = sum(overlap_i
/ length_i)``.  The rate is that sum over the window's length, and the
iteration time is the mean of the iterations' lengths weighted by the
same shares.  Both take all the work and all the time of the window, and
neither depends on where its edges cut.  An iteration still running at
the window's close is waited for after it, so its length is known.

The interval arithmetic (union, busy share, overlap) is copied from the
port's ``chip_smoke.py`` (``busy_share``, ``_union``, ``host_overlap``)
with the window, not the span of the events, as the denominator.
"""

from __future__ import annotations

import statistics


def window_iterations(iters, t0: float, t1: float) -> tuple:
    """``(count, mean length s)`` of the AL iterations (dicts with ``t0``,
    ``t1`` and ``epoch``; the baseline evaluation, epoch -1, is not an
    iteration) by the window rule; ``(0.0, None)`` when none overlaps."""
    count = weighted = 0.0
    for it in iters:
        if it["epoch"] < 0 or it.get("t1") is None:
            continue
        length = it["t1"] - it["t0"]
        inside = min(it["t1"], t1) - max(it["t0"], t0)
        if length <= 0 or inside <= 0:
            continue
        w = inside / length
        count += w
        weighted += w * length
    return count, (weighted / count if count else None)


def union(spans) -> list:
    """Sorted, disjoint ``[lo, hi]`` intervals covering ``spans``."""
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def clip(spans, t0, t1) -> list:
    return [(max(lo, t0), min(hi, t1)) for lo, hi in spans
            if hi > t0 and lo < t1]


def busy(spans, t0, t1) -> float:
    """Length of the union of ``spans`` inside ``[t0, t1]``."""
    return sum(hi - lo for lo, hi in union(clip(spans, t0, t1)))


def gaps(spans, t0, t1) -> list:
    """The ``(lo, hi)`` stretches of ``[t0, t1]`` no span covers."""
    out, cur = [], t0
    for lo, hi in union(clip(spans, t0, t1)):
        if lo > cur:
            out.append((cur, lo))
        cur = max(cur, hi)
    if cur < t1:
        out.append((cur, t1))
    return out


def overlap_share(dev_spans, host_spans):
    """The share of the union of ``dev_spans`` that some host span
    covers; ``None`` without either."""
    dev, host = union(dev_spans), union(host_spans)
    if not dev or not host:
        return None
    both, j = 0.0, 0
    for lo, hi in dev:
        while j < len(host) and host[j][1] <= lo:
            j += 1
        k = j
        while k < len(host) and host[k][0] < hi:
            both += min(hi, host[k][1]) - max(lo, host[k][0])
            k += 1
    return both / sum(hi - lo for lo, hi in dev)


def spread(values) -> float:
    """Interquartile range over the median, by Python's
    ``statistics.quantiles(values, n=4)``."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
