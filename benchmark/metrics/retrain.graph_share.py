"""The share of the member fits starting in the window that replayed a
captured CUDA graph of their epochs (the ``retrain.fit`` spans'
``graphed`` attribute), in %.  Where no fit in the window carries the
attribute (a program that writes none), nothing is read."""

from benchmark import spans


def read(ctx):
    t0, t1 = ctx.window
    fits = [s for s in spans.named(ctx.spans, "retrain.fit")
            if t0 <= s["t0"] < t1]
    if not any("graphed" in s for s in fits):
        return None
    return 100.0 * sum(bool(s.get("graphed")) for s in fits) / len(fits)
