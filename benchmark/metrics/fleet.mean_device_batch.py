"""Users served by one device dispatch, averaged over the dispatches the
window opened (the scheduler's dispatch spans, which carry
``FleetReport.dispatch``'s batch)."""


def read(ctx):
    t0, t1 = ctx.window
    batches = [s["batch"] for s in ctx.spans
               if s.get("name") in ("retrain", "score_dispatch")
               and t0 <= s["t0"] < t1]
    return sum(batches) / len(batches) if batches else None
