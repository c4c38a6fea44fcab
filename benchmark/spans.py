"""The program's own spans in a traced run (``ctx.spans``: the records of
the port's ``Tracer``, unix-epoch s, the clock of the profiler's events),
reduced to what the span metrics read: the intervals of the spans of one
name, set differences and overlaps of such intervals, and each span's
children.  Where the program writes no span of a name (a program older
than these spans), the readers find nothing and read ``None``."""

from __future__ import annotations

from benchmark import stats


def named(spans, name: str) -> list:
    return [s for s in spans if s.get("name") == name]


def intervals(spans, name: str) -> list:
    """``(start, end)`` of every span called ``name``."""
    return [(s["t0"], s["t0"] + s["dur_s"]) for s in named(spans, name)]


def subtract(a, b) -> list:
    """The stretches of the union of ``a`` that the union of ``b`` leaves
    uncovered."""
    return [g for lo, hi in stats.union(a) for g in stats.gaps(b, lo, hi)]


def overlap(a, b) -> float:
    """Length of the intersection of the unions of ``a`` and ``b``."""
    return (stats.overlap_share(a, b) or 0.0) * sum(
        hi - lo for lo, hi in stats.union(a))


def idle_inside(ctx, host) -> float | None:
    """Seconds of the window in which the card ran nothing while one of
    the ``host`` intervals was open; ``None`` without a device trace or
    without such intervals."""
    if ctx.trace is None or not ctx.trace.kernels or not host:
        return None
    t0, t1 = ctx.window
    return overlap(stats.gaps(ctx.trace.spans, t0, t1), host)


def window_wall(ctx, name: str) -> float | None:
    """Wall seconds of the spans called ``name`` inside the window, summed
    (over threads too); ``None`` where the program wrote none."""
    found = intervals(ctx.spans, name)
    if not found:
        return None
    t0, t1 = ctx.window
    return sum(hi - lo for lo, hi in stats.clip(found, t0, t1))


def per_iteration_ms(ctx, seconds: float | None) -> float | None:
    if seconds is None or not ctx.iterations:
        return None
    return 1e3 * seconds / ctx.iterations
