"""The share of the device's busy time (kernels and copies, profiler)
during which a pooled host step (``FleetReport.host_steps``) ran: how far
the fleet hides host work under device work.  A copy of the port's
``chip_smoke.host_overlap``, restricted to the window."""

from benchmark import stats


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    t0, t1 = ctx.window
    host = [(a / 1e9, b / 1e9) for _, a, b in ctx.report.host_steps]
    share = stats.overlap_share(stats.clip(ctx.trace.spans, t0, t1),
                                stats.clip(host, t0, t1))
    return None if share is None else 100.0 * share
