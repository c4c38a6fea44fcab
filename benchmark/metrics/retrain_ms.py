"""Host-clock ms of the ``cnn_retrain`` dispatches inside the window, per
AL iteration (the window rule's count).  A retrain dispatch ends in a host
read of its history, so its wall clock holds its device work."""


def read(ctx):
    t0, t1 = ctx.window
    wall = sum(max(0.0, min(s["t0"] + s["dur_s"], t1) - max(s["t0"], t0))
               for s in ctx.spans if s.get("fn") == "cnn_retrain")
    return 1e3 * wall / ctx.iterations if wall and ctx.iterations else None
