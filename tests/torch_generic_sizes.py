"""The fitted sizes of scikit-learn's generic members at DEAM scale.

``chip_smoke.py`` phase 22 builds rf, gbc, svc and gpc members from
seeded synthetic fitted state, since the card machine has no
scikit-learn; this script measures the sizes that state copies, by
fitting the JAX registry's estimators (``consensus_entropy_tpu/train/
pretrain.py:49-63``) with scikit-learn on phase 12's DEAM-scale rows
(1,802 songs x 60 frames x 260 features, seed 1987 + 8): rf on every row;
svc and gpc on the first 2,000 rows (gpc is cubic in its rows); gbc's
depth-2 trees hold at most 7 nodes each whatever the rows, so it is
fitted on the first 20,000 for time.  It prints one JSON object: trees
and node counts, support vectors per class, the fitted hyperparameters.

    python -m tests.torch_generic_sizes [--jobs N]
"""

import argparse
import json
import time
import warnings

import numpy as np

DEAM_SONGS, DEAM_FRAMES, F, C, SEED = 1802, 60, 260, 4, 1987
CUT_ROWS, GBC_ROWS = 2000, 20000


def deam_scale_rows():
    """``chip_smoke.py`` phase 12's rows."""
    rng = np.random.default_rng(SEED + 8)
    n = DEAM_SONGS * DEAM_FRAMES
    y = rng.integers(0, C, n)
    centers = rng.normal(0, 0.5, (C, F)).astype(np.float32)
    x = rng.standard_normal((n, F), np.float32) + centers[y]
    return x, y


def main(argv=None) -> int:
    from sklearn.ensemble import (
        GradientBoostingClassifier,
        RandomForestClassifier,
    )
    from sklearn.gaussian_process import GaussianProcessClassifier
    from sklearn.gaussian_process.kernels import RBF
    from sklearn.svm import SVC

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--jobs", type=int, default=4,
                   help="processes for the forest's trees (default 4)")
    args = p.parse_args(argv)
    warnings.simplefilter("ignore")
    x, y = deam_scale_rows()
    out, walls = {}, {}
    t0 = time.perf_counter()
    rf = RandomForestClassifier(random_state=SEED, warm_start=True,
                                n_jobs=args.jobs).fit(x, y)
    walls["rf"] = time.perf_counter() - t0
    nodes = [int(t.tree_.node_count) for t in rf.estimators_]
    depth = [int(t.tree_.max_depth) for t in rf.estimators_]
    out["rf"] = {"rows": len(x), "trees": len(nodes),
                 "nodes_min": min(nodes), "nodes_median":
                 int(np.median(nodes)), "nodes_max": max(nodes),
                 "nodes_total": sum(nodes), "depth_max": max(depth)}
    t0 = time.perf_counter()
    gbc = GradientBoostingClassifier(max_depth=2, random_state=SEED,
                                     warm_start=True).fit(x[:GBC_ROWS],
                                                          y[:GBC_ROWS])
    walls["gbc"] = time.perf_counter() - t0
    gnodes = [int(t.tree_.node_count) for t in gbc.estimators_.ravel()]
    out["gbc"] = {"rows": GBC_ROWS, "stages": int(gbc.n_estimators_),
                  "trees": len(gnodes), "nodes_min": min(gnodes),
                  "nodes_max": max(gnodes),
                  "learning_rate": float(gbc.learning_rate)}
    t0 = time.perf_counter()
    svc = SVC(probability=True, random_state=SEED).fit(x[:CUT_ROWS],
                                                       y[:CUT_ROWS])
    walls["svc"] = time.perf_counter() - t0
    out["svc"] = {"rows": CUT_ROWS,
                  "n_support": [int(v) for v in svc.n_support_],
                  "gamma": float(svc._gamma),
                  "prob_a": [float(v) for v in svc._probA],
                  "prob_b": [float(v) for v in svc._probB],
                  "dual_coef_abs_max": float(np.abs(svc._dual_coef_).max())}
    t0 = time.perf_counter()
    gpc = GaussianProcessClassifier(kernel=1.0 * RBF(1.0),
                                    random_state=SEED, warm_start=True
                                    ).fit(x[:CUT_ROWS], y[:CUT_ROWS])
    walls["gpc"] = time.perf_counter() - t0
    ests = gpc.base_estimator_.estimators_
    out["gpc"] = {"rows": CUT_ROWS, "binary": len(ests),
                  "constant": [float(e.kernel_.k1.constant_value)
                               for e in ests],
                  "length_scale": [float(e.kernel_.k2.length_scale)
                                   for e in ests],
                  "pi_min": min(float(e.pi_.min()) for e in ests),
                  "pi_max": max(float(e.pi_.max()) for e in ests)}
    out["fit_s"] = {k: round(v, 1) for k, v in walls.items()}
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
