"""Host-clock seconds of one boosting stage's trees built the two ways the
tree core offers: the trees in parallel, or in turn with each node's
drawn features scanned in parallel (``native.trees_build``'s
``parallel_features``; the same trees either way).

Four squared-error trees (a stage of the 4-class gbc and boosted-slot
fits) on the first 2,000 rows of ``chip_smoke.py`` phase 12's DEAM-scale
rows, every feature drawn, at depth 2 (gbc) and 5 (the boosted slot),
seeded standard-normal targets; each figure the mean of 3 builds, the two
ways alternated twice.  Prints the card's name and power limit, the CPU
count and one JSON object.

    PYTHONPATH=. python tests/torch_tree_modes.py
"""

import json
import os
import subprocess
import time

import numpy as np

from chip_smoke import GENERIC_CUT_ROWS, deam_scale_rows
from consensus_entropy_tpu_torch import native


def main() -> int:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except FileNotFoundError:
        smi = "no nvidia-smi"
    print(f"{smi}; {os.cpu_count()} CPUs")
    x, _, _, _ = deam_scale_rows()
    X = np.ascontiguousarray(x[:GENERIC_CUT_ROWS])
    g = np.random.default_rng(0).standard_normal((4, GENERIC_CUT_ROWS))
    sw = np.ones(GENERIC_CUT_ROWS)
    seeds = np.arange(1, 5, dtype=np.uint32)
    out = {}
    for depth in (2, 5):
        for parallel_features in (False, True, False, True):
            t0 = time.perf_counter()
            for _ in range(3):
                native.trees_build(X, g, sw, seeds, criterion="mse",
                                   max_features=X.shape[1], max_depth=depth,
                                   parallel_features=parallel_features)
            key = f"depth_{depth}_" + ("features" if parallel_features
                                       else "trees")
            out.setdefault(key, []).append((time.perf_counter() - t0) / 3)
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
