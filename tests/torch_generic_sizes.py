"""scikit-learn's fingerprints of the fits ``chip_smoke.py`` phase 22
makes without it.

Phase 22 fits the JAX registry's estimators (``consensus_entropy_tpu/
train/pretrain.py:49-63``) with the port's fitters on phase 12's
DEAM-scale rows (1,802 songs x 60 frames x 260 features, seed 1987 + 8):
rf on the first GENERIC_RF_ROWS (20,000) rows; gbc, svc, gpc and the
boosted slot's scikit-learn member (the JAX package's
``BoostedTreesMember``, ``make_boosted_member(impl="sklearn")``) on the
first GENERIC_CUT_ROWS (2,000), the boosted slot then updated twice
(``chip_smoke.generic_update_batches``).  This script makes the same fits
with scikit-learn and prints, as one JSON object, what phase 22 holds its
fits to (``chip_smoke.generic_fingerprint``: node counts and depths,
leaf sums, support counts, Platt parameters, kernel parameters, the
probability column sums and ``predict`` ids on the last 64 rows) and each
fit's seconds; ``chip_smoke.GENERIC_SIZES`` records its output.

    python -m tests.torch_generic_sizes [--jobs N]
"""

import argparse
import json
import time
import warnings

from chip_smoke import (
    GENERIC_CUT_ROWS,
    GENERIC_RF_ROWS,
    GENERIC_SAMPLE_ROWS,
    SEED,
    deam_scale_rows,
    generic_fingerprint,
    generic_update_batches,
)


def main(argv=None) -> int:
    from consensus_entropy_tpu.models.sklearn_members import (
        make_boosted_member,
    )
    from consensus_entropy_tpu.train.pretrain import _registry
    from consensus_entropy_tpu_torch import convert

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--jobs", type=int, default=1,
                   help="threads for the forest's trees (default 1: the "
                        "trees do not depend on it)")
    args = p.parse_args(argv)
    warnings.simplefilter("ignore")
    x, y, _, _ = deam_scale_rows()
    sample = x[-GENERIC_SAMPLE_ROWS:]
    out, walls = {}, {}
    for kind in ("rf", "gbc", "svc", "gpc"):
        rows = GENERIC_RF_ROWS if kind == "rf" else GENERIC_CUT_ROWS
        est = _registry(SEED)[kind]("it_0").estimator
        if kind == "rf":
            est.set_params(n_jobs=args.jobs)
        t0 = time.perf_counter()
        est.fit(x[:rows], y[:rows])
        walls[kind] = time.perf_counter() - t0
        state = convert.generic_from_estimator("it_0", kind, est).state
        out[kind] = generic_fingerprint(kind, state, sample)
    t0 = time.perf_counter()
    boosted = make_boosted_member("it_0", seed=SEED, impl="sklearn").fit(
        x[:GENERIC_CUT_ROWS], y[:GENERIC_CUT_ROWS])
    walls["xgb"] = time.perf_counter() - t0
    out["xgb"] = [generic_fingerprint("xgb",
                                      convert._gbc_state(boosted.estimator),
                                      sample)]
    for i, (xb, yb) in enumerate(generic_update_batches(x, y)):
        t0 = time.perf_counter()
        boosted.update(xb, yb)
        walls[f"xgb_update_{i}"] = time.perf_counter() - t0
        out["xgb"].append(generic_fingerprint(
            "xgb", convert._gbc_state(boosted.estimator), sample))
    out["fit_s"] = walls
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
