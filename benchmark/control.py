"""The correctness check's readings on the card, for setting its limits.

    python3 -m benchmark.control --workload vgg.cohort4-mc \
        --seeds 11,12,13 --seconds 10

Runs the cell once a seed, in one process, and prints a JSON line a
seed: each compared number of the system under test, and the control's
(``control_<number>``): the plain reference in TF32, the nearest
precision below the float32 with TF32 off that the configurations state,
put in the system's place at the same iterations; and the readings of the
retrain's and the host updates' faults put in its place (``fault_<name>``,
``benchmark.check``), with each compared retrain member's detail.  With
``--faults`` the runs go on with those faults planted in the system
(``benchmark.faults``) and read what a broken system gives.  The
benchmark's own runs do neither.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import run, spec
from benchmark.faults import planted


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--faults", default="",
                   help="comma-separated faults (benchmark.faults) planted "
                        "in every run: the readings of a broken system")
    args = p.parse_args(argv)
    run.steady_threads()
    run._caches(spec.REPO)
    import torch

    if not torch.cuda.is_available():
        print("[control] no CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    faults = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        with planted(faults):
            line = run.run_cell(cell, seed, args.seconds, False, "cuda",
                                t_start=time.time(), control=not faults)
        print(json.dumps({"seed": seed, "correct": line["correct"],
                          "checks": line["checks"],
                          "faults": faults,
                          "control": line.get("control"),
                          "metrics": line["metrics"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
