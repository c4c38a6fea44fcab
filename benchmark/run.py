"""Run one cell of the benchmark once, on the card, and print one JSON line.

    python3 -m benchmark.run --workload vgg.cohort4-mc --seed 7 \
        --seconds 10 --trace 0

The run sets up, warms up, measures for ``--seconds``, checks what the
timed path produced against the plain reference (``benchmark.check``), and
prints, as its last line of standard output, ``{"correct", "attempted",
"failed", "metrics", "device", ["breakdown",] "checks"}``.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics,
read under ``torch.profiler``.  Each compared number is printed beside its
limit as the last lines of standard error and under ``checks``.

It exits non-zero without a result when no card is found (it never falls
back to the CPU), and when a module of JAX, Flax or the JAX package is
loaded in its process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import spec  # noqa: E402

#: top-level module names the port's process must never load
FOREIGN = ("jax", "jaxlib", "flax", "consensus_entropy_tpu")


def foreign_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    :data:`FOREIGN` (the port's own name begins with the JAX package's)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FOREIGN})


#: one thread to each BLAS and OpenMP team the process starts by default:
#: the host workers' boosted-tree fits set their own share of the cores
#: (two of eight with four users), and four workers' numpy calls each
#: starting a team of eight would crowd the cores the device's launches
#: run from
THREADS = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}


def steady_threads() -> None:
    """Set :data:`THREADS`; before numpy or torch is imported."""
    os.environ.update(THREADS)


def _caches(root) -> None:
    """Fixed build and kernel cache directories inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        path = os.path.join(root, ".bench_cache", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, *,
             t_start: float = T_START, log=_log, control: bool = False
             ) -> dict:
    """One run of ``cell``: the result line's fields (``"checks"`` holds
    each compared number with its limit)."""
    import torch

    from benchmark import check
    from benchmark.trace import breakdown

    res = spec.driver(cell.traffic).run(cell, seed, seconds, trace, device,
                                        t_start, log=log)
    ctx = res["ctx"]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"], here=cell.here)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = str(device).startswith("cuda")
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": False, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    if trace and ctx.trace is not None:
        from benchmark import stats

        t0, t1 = ctx.window
        dev["busy_s"] = stats.busy(ctx.trace.spans, t0, t1)
        dev["window_s"] = t1 - t0
        line["breakdown"] = breakdown(ctx.trace, ctx.spans,
                                      ctx.report.host_steps, t0, t1)
    res["free"]()
    c0 = time.time()
    try:
        numbers = check.compare(*res["check_args"][:1], cell.config,
                                cell.traffic, cell.limits,
                                *res["check_args"][1:], seed,
                                control=control)
    finally:
        res["cleanup"]()
    correct, rows = check.verdict(numbers, cell.limits)
    line["correct"] = correct and res["failed"] == 0
    log(f"[benchmark] check {time.time() - c0:.1f} s: "
        f"{numbers['iterations_compared']} selections and "
        f"{numbers['retrains_compared']} retrains compared")
    if control:
        line["control"] = {k: v for k, v in numbers.items()
                           if k.startswith(("control_", "fault_"))
                           or k == "retrains"}
    for name, value, limit in rows:
        log(f"{name} {value!r} limit {limit!r}")
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in rows}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    steady_threads()
    _caches(spec.REPO)
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _log(f"[benchmark] {args.workload} needs {cell.chips} CUDA "
             f"device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = foreign_modules()
    if bad:
        _log(f"[benchmark] loaded in the benchmark's process: {bad}")
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
