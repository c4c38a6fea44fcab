"""Device-idle ms per AL iteration while the scheduler's pump was blocked
on host steps (``host_wait`` spans: the launching thread had no device
step to launch): the gaps of the profiler's busy union in the window
that those spans cover, over the window rule's iterations."""

from benchmark import spans


def read(ctx):
    return spans.per_iteration_ms(
        ctx, spans.idle_inside(ctx, spans.intervals(ctx.spans,
                                                    "host_wait")))
