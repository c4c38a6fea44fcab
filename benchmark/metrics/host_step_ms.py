"""Host-clock ms of the pooled host steps (``FleetReport.host_steps``:
the host members' predictions, updates and evaluation, the checkpoint
boundaries) inside the window, summed over the workers, per AL
iteration."""


def read(ctx):
    t0, t1 = ctx.window
    wall = sum(max(0.0, min(b / 1e9, t1) - max(a / 1e9, t0))
               for _, a, b in ctx.report.host_steps)
    return 1e3 * wall / ctx.iterations if wall and ctx.iterations else None
