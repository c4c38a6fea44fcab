"""Device ms, per AL iteration, of the kernels that the ``cnn_probs``
dispatches (the CNN forward over the pool) launched inside the window.  A
score dispatch returns before its device work ends (its result is read
later), so its host wall clock would time only the launches: a kernel
counts where its launch's host time falls inside a dispatch.  A trace
that lacks a kernel's launch time gives nothing to read."""

import bisect


def read(ctx):
    if ctx.trace is None or not ctx.iterations:
        return None
    if any(k.launch is None for k in ctx.trace.kernels):
        return None
    t0, t1 = ctx.window
    spans = sorted((s["t0"], s["t0"] + s["dur_s"]) for s in ctx.spans
                   if s.get("name") == "score_dispatch"
                   and s.get("fn") == "cnn_probs")
    starts = [a for a, _ in spans]
    busy = 0.0
    for k in ctx.trace.kernels:
        i = bisect.bisect_right(starts, k.launch) - 1
        if i >= 0 and k.launch <= spans[i][1]:
            busy += max(0.0, min(k.t1, t1) - max(k.t0, t0))
    return 1e3 * busy / ctx.iterations if busy else None
