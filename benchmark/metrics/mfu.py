"""The whole step's share of the card's float32 peak: the CNN members'
operations that the window's share of each iteration needs
(``benchmark.flops``: the score and evaluation forwards of real songs or
windows, not padding, and each trained crop's forward and backward), over
the window's length times 67 TFLOP/s (H100 SXM, float32 outside the
tensor cores, the precision the configurations state).  Read only where
the trace saw the card: a run elsewhere gives no share of its peak."""

from benchmark import flops


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or not ctx.work.flops:
        return None
    return 100.0 * ctx.work.flops / (ctx.seconds * flops.PEAK_FLOPS)
