"""The convolutions' share of their roofline: the least time the
window's convolutions could take (``benchmark.flops``: each one's
operations over 67 TFLOP/s or its bytes over 3.35 TB/s, whichever is
larger, forward and backward), over the device time of cuDNN's
convolution kernels in the window (profiler; ``benchmark.trace.
CONV_KERNELS``)."""


def read(ctx):
    if ctx.trace is None:
        return None
    t0, t1 = ctx.window
    busy = sum(max(0.0, min(k.t1, t1) - max(k.t0, t0))
               for k in ctx.trace.kernels if k.conv)
    if not busy or not ctx.work.conv_bound_s:
        return None
    return 100.0 * ctx.work.conv_bound_s / busy
