"""The launching thread's CPU time over its wall time inside the member
fits that start in the window, each fit less its history read
(``retrain.fit`` and ``retrain.read`` spans, their ``cpu_s``).  Under
100%: the thread was runnable but off the CPU for the rest, waiting for
the interpreter lock or the OS (a full launch queue also blocks it)."""

from benchmark import spans


def read(ctx):
    t0, t1 = ctx.window
    reads = {s["parent"]: s for s in spans.named(ctx.spans, "retrain.read")}
    cpu = wall = 0.0
    for fit in spans.named(ctx.spans, "retrain.fit"):
        rd = reads.get(fit["span"])
        if not t0 <= fit["t0"] < t1 or "cpu_s" not in fit or rd is None \
                or "cpu_s" not in rd:
            continue
        cpu += fit["cpu_s"] - rd["cpu_s"]
        wall += fit["dur_s"] - rd["dur_s"]
    return 100.0 * cpu / wall if wall > 0 else None
