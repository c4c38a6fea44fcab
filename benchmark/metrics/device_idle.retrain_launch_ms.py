"""Device-idle ms per AL iteration while the launching thread was inside
a member's fit (``retrain.fit`` spans) and not in its history's read
(``retrain.read``): the gaps of the profiler's busy union in the window
that those stretches cover, over the window rule's iterations.  The card
waits there on the thread's launches (Python, the interpreter lock, the
launch calls), not on a read."""

from benchmark import spans


def read(ctx):
    launch = spans.subtract(spans.intervals(ctx.spans, "retrain.fit"),
                            spans.intervals(ctx.spans, "retrain.read"))
    return spans.per_iteration_ms(ctx, spans.idle_inside(ctx, launch))
