"""The card's idle time in a traced run, split by what the launching
thread was doing, from the port's spans (PERF.md section 5).

    python3 -m benchmark.span_report --workload vgg.cohort4-mc --seed N \\
        --seconds 51 [--out report.json]

One traced run of the cell as ``benchmark.run --trace 1`` makes it,
without the check.  Prints one JSON object: the per-layer metrics, and
:func:`analyze`'s numbers (ms are per AL iteration by the window rule):

- ``idle_split_ms``: the gaps of the profiler's busy union in the window,
  put down to the first of these that covers them: a fit's launches (the
  ``retrain.fit`` spans less their ``retrain.read``), a fit's read, a
  ``retrain`` dispatch outside its fits, a ``host_wait`` span, a
  ``score_dispatch`` span; ``rest`` is what none covers;
- ``alignment``: of the kernels launched inside a ``retrain`` span, how
  many were launched inside a ``retrain.fit`` span (the spans and the
  profiler share a clock);
- ``launches``: the kernels launched in the window inside the fits'
  launch stretches, the stretches' wall and the kernels' device time
  each, launches a member-epoch, the card's busy share in the stretches,
  and the share of the stretches under a pooled host step;
- ``sums_ms``: the ``retrain`` dispatches' wall against the reads plus
  the fits less their reads;
- ``updates``: the ``member.update`` spans by ``kind``: wall clipped to
  the window, and ``cpu_s`` over wall of those that start in it;
- ``tracer``: the tracer's ``cost_s`` and records inside the window.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys
import time

T_START = time.time()

from benchmark import spans, spec, stats  # noqa: E402


def _inside(intervals):
    """A test of whether a time lies in the union of ``intervals``."""
    u = stats.union(intervals)
    starts = [lo for lo, _ in u]

    def test(t) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= u[i][1]
    return test


def analyze(ctx) -> dict:
    t0, t1 = ctx.window
    S = ctx.spans
    per = (lambda s: 1e3 * s / ctx.iterations) if ctx.iterations else \
        (lambda s: None)
    iv = lambda name: spans.intervals(S, name)  # noqa: E731
    fits, reads = iv("retrain.fit"), iv("retrain.read")
    launch = spans.subtract(fits, reads)
    out = {"iterations": ctx.iterations, "window_s": t1 - t0}

    parts = {"retrain_launch": launch, "retrain_read": reads,
             "retrain_outside_fits": spans.subtract(iv("retrain"), fits),
             "host_wait": iv("host_wait"),
             "score_dispatch": iv("score_dispatch")}
    hosts = [(a / 1e9, b / 1e9) for _, a, b in ctx.report.host_steps]
    if ctx.trace is not None and ctx.trace.kernels:
        left = stats.gaps(ctx.trace.spans, t0, t1)
        split = {"idle": per(sum(b - a for a, b in left))}
        for name, cover in parts.items():
            split[name] = per(spans.overlap(left, cover))
            left = [g for lo, hi in left for g in stats.gaps(cover, lo, hi)]
        split["rest"] = per(sum(b - a for a, b in left))
        out["idle_split_ms"] = split

        in_disp, in_fit = _inside(iv("retrain")), _inside(fits)
        launched = [k for k in ctx.trace.kernels if k.launch is not None]
        disp = [k for k in launched if in_disp(k.launch)]
        n_fit = sum(in_fit(k.launch) for k in disp)
        out["alignment"] = {
            "kernels_launched_in_retrain": len(disp),
            "of_them_in_a_fit": n_fit,
            "share": n_fit / len(disp) if disp else None}

        launch_u, in_launch = stats.union(launch), _inside(launch)
        mine = [k for k in launched
                if t0 <= k.launch < t1 and in_launch(k.launch)]
        wall = sum(b - a for a, b in stats.clip(launch_u, t0, t1))
        n_fits = sum(1 for s in spans.named(S, "retrain.fit")
                     if t0 <= s["t0"] < t1)
        epochs = ctx.config.get("retrain_epochs")
        out["launches"] = {
            "kernels": len(mine),
            "host_us_each": 1e6 * wall / len(mine) if mine else None,
            "device_us_each": (1e6 * sum(k.t1 - k.t0 for k in mine)
                               / len(mine) if mine else None),
            "per_member_epoch": (len(mine) / (n_fits * epochs)
                                 if n_fits and epochs else None),
            "busy_share": (spans.overlap(stats.clip(launch_u, t0, t1),
                                         ctx.trace.spans) / wall
                           if wall else None),
            "under_host_steps": (spans.overlap(launch_u, hosts)
                                 / sum(b - a for a, b in launch_u)
                                 if launch_u else None)}

    ww = lambda name: spans.window_wall(ctx, name) or 0.0  # noqa: E731
    out["sums_ms"] = {
        "retrain": per(ww("retrain")), "read": per(ww("retrain.read")),
        "fit_less_read": per(ww("retrain.fit") - ww("retrain.read"))}

    kinds = collections.defaultdict(lambda: [0.0, 0.0, 0.0, 0])
    for s in spans.named(S, "member.update"):
        k = kinds[s["kind"]]
        k[0] += sum(b - a for a, b in stats.clip(
            [(s["t0"], s["t0"] + s["dur_s"])], t0, t1))
        if t0 <= s["t0"] < t1 and "cpu_s" in s:
            k[1] += s["cpu_s"]
            k[2] += s["dur_s"]
            k[3] += 1
    out["updates"] = {
        kind: {"ms": per(v[0]), "cpu_share": v[1] / v[2] if v[2] else None,
               "n": v[3]} for kind, v in sorted(kinds.items())}
    return out


class _Capture:
    """Keeps the traffic driver's tracer, and its ``cost_s`` and record
    count at the device trace's start and stop (the window's edges)."""

    def __init__(self):
        from benchmark.drivers import cohort
        from benchmark.trace import DeviceTrace

        self.clock, self.marks = None, []
        self._undo = [(cohort, "make_clock", cohort.make_clock),
                      (DeviceTrace, "start", DeviceTrace.start),
                      (DeviceTrace, "stop", DeviceTrace.stop)]
        make_clock, start, stop = (u[2] for u in self._undo)

        def clock(enabled):
            self.clock = make_clock(enabled)
            return self.clock

        def mark(orig, first):
            def wrapped(trace):
                if not first:
                    orig(trace)
                self.marks.append((self.clock.cost_s,
                                   len(self.clock.records)))
                if first:
                    orig(trace)
            return wrapped

        cohort.make_clock = clock
        DeviceTrace.start = mark(start, True)
        DeviceTrace.stop = mark(stop, False)

    def restore(self):
        for owner, name, orig in self._undo:
            setattr(owner, name, orig)

    def tracer(self) -> dict:
        (c0, n0), (c1, n1) = self.marks[:2]
        return {"cost_s_window": c1 - c0, "records_window": n1 - n0,
                "cost_s_run": self.clock.cost_s}


def report(cell, seed: int, seconds: float, device, *,
           t_start: float = T_START, log=None) -> dict:
    """One traced run of ``cell`` and its analysis."""
    from benchmark import run

    cap = _Capture()
    try:
        res = spec.driver(cell.traffic).run(
            cell, seed, seconds, True, device, t_start, log=log or run._log)
    finally:
        cap.restore()
    ctx = res["ctx"]
    try:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"], here=cell.here)(ctx)
            if value is not None:
                metrics[m["name"]] = value
        return {"seed": seed, "metrics": metrics, "analysis": analyze(ctx),
                "tracer": cap.tracer(),
                "memory_peak_bytes": res["memory_peak_bytes"]}
    finally:
        res["free"]()
        res["cleanup"]()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    from benchmark import run

    run.steady_threads()
    run._caches(spec.REPO)
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    out = report(cell, args.seed, args.seconds, "cuda")
    text = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
