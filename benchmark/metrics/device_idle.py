"""The share of the window in which no kernel or copy ran on the card
(profiler; the union of the device intervals over the window's length)."""

from benchmark import stats


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    t0, t1 = ctx.window
    return 100.0 * (1.0 - stats.busy(ctx.trace.spans, t0, t1) / (t1 - t0))
