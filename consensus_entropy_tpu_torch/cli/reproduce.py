"""``reproduce``: the paper's pipeline on the port — pre-train the committee
on DEAM, then personalize it per AMG1608 user in every acquisition mode.

Counterpart of ``scripts/reproduce.sh``, with its defaults and overrides:
``deam_classifier -cv CV -m MODEL`` for each model (default ``gnb sgd xgb
cnn_jax``, 5 folds each: 20 members), then ``amg_test -q QUERIES -e EPOCHS
-n NUM_ANNO -m MODE --mesh auto`` for each mode (default ``mc hc mix
rand``: machine consensus, human consensus, hybrid, random control),
EXTRA flags appended to every ``amg_test`` run (``run_pipeline`` also
takes flags for every ``deam_classifier`` run).  Each CLI's ``main`` runs
in this process, in order, and its host-clock time is logged; the first
that fails ends the pipeline with its exit code.  It
runs on ``cuda`` unless ``--device cpu`` is passed, and raises without
CUDA.

``--smoke`` proves the whole pipeline from a pristine tree: it writes the
synthetic DEAM + AMG layout (``data/synth.py``, seed 0) into a temporary
directory and runs it with the smoke budgets of ``reproduce.sh --smoke``:
``-cv 2 -q 2 -e 2 -n 4``, models ``gnb sgd``, modes ``mc rand``,
``--max-users 1``.

    python -m consensus_entropy_tpu_torch.cli.reproduce MODELS DEAM AMG
    python -m consensus_entropy_tpu_torch.cli.reproduce --smoke --device cpu
"""

from __future__ import annotations

import argparse
import os
import shlex
import sys
import tempfile
import time

from consensus_entropy_tpu_torch.cli.common import add_device_arg

MODELS = ("gnb", "sgd", "xgb", "cnn_jax")
MODES = ("mc", "hc", "mix", "rand")
#: ``reproduce.sh --smoke``'s budgets
SMOKE = {"cv": 2, "queries": 2, "epochs": 2, "num_anno": 4,
         "models": ("gnb", "sgd"), "modes": ("mc", "rand"),
         "extra": ("--max-users", "1")}
SMOKE_SEED = 0


def run_pipeline(models_root: str, deam_root: str, amg_root: str, *,
                 device: str = "cuda", cv: int = 5, queries: int = 10,
                 epochs: int = 10, num_anno: int = 150, models=MODELS,
                 modes=MODES, extra=(), pretrain_extra=(),
                 log=print) -> dict:
    """Pre-train every model in ``models``, then run ``amg_test --mesh
    auto`` for each mode in ``modes``.  Returns ``rc`` (0, or the first
    failing CLI's exit code) and ``calls``: each CLI call's ``cli``,
    ``argv``, host-clock ``start`` (``time.perf_counter``), ``seconds``
    and ``rc``, in order."""
    from consensus_entropy_tpu_torch.cli import amg_test, deam_classifier
    from consensus_entropy_tpu_torch.device import resolve_device

    resolve_device(device)  # no CUDA and no --device cpu: raise first
    flags = ["--models-root", models_root, "--deam-root", deam_root,
             "--amg-root", amg_root, "--device", device]
    steps = [(deam_classifier, ["-cv", str(cv), "-m", model,
                                *pretrain_extra]) for model in models]
    steps += [(amg_test, ["-q", str(queries), "-e", str(epochs), "-n",
                          str(num_anno), "-m", mode, "--mesh", "auto",
                          *extra]) for mode in modes]
    calls = []
    for cli, argv in steps:
        name = cli.__name__.rsplit(".", 1)[-1]
        log(f"reproduce: {name} {shlex.join(argv)}")
        t0 = time.perf_counter()
        rc = cli.main([*argv, *flags])
        secs = time.perf_counter() - t0
        calls.append({"cli": name, "argv": argv, "start": t0,
                      "seconds": secs, "rc": rc})
        if rc != 0:
            log(f"reproduce: {name} exited {rc} after {secs:.1f} s")
            return {"rc": rc, "calls": calls}
        log(f"reproduce: {name} done in {secs:.1f} s")
    log(f"done: per-user reports under "
        f"{os.path.join(models_root, 'users', '<uid>', '<mode>')}")
    return {"rc": 0, "calls": calls}


def smoke(root: str, device: str = "cuda", log=print) -> dict:
    """``--smoke`` into ``root``: the synthetic tree, then the pipeline at
    the smoke budgets.  Returns the tree's paths, the exit code and the
    calls (:func:`run_pipeline`)."""
    import numpy as np

    from consensus_entropy_tpu_torch.data.synth import build_synth_roots

    roots = build_synth_roots(root, np.random.default_rng(SMOKE_SEED))
    log(f"synthetic tree: deam={roots['deam']} amg={roots['amg']}")
    run = run_pipeline(roots["models"], roots["deam"], roots["amg"],
                       device=device, cv=SMOKE["cv"],
                       queries=SMOKE["queries"], epochs=SMOKE["epochs"],
                       num_anno=SMOKE["num_anno"], models=SMOKE["models"],
                       modes=SMOKE["modes"], extra=SMOKE["extra"], log=log)
    return {**roots, **run}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="pre-train the committee on DEAM, then run per-user "
                    "AL on AMG1608 in every acquisition mode")
    p.add_argument("models_root", nargs="?", default="./models")
    p.add_argument("deam_root", nargs="?", default="./data/deam")
    p.add_argument("amg_root", nargs="?", default="./data/amg1608")
    p.add_argument("--smoke", action="store_true",
                   help="the whole pipeline on a synthetic tree in a "
                        "temporary directory, at the smoke budgets")
    p.add_argument("-cv", dest="cv", type=int, default=5,
                   help="pre-training folds a model (default 5)")
    p.add_argument("-q", dest="queries", type=int, default=10)
    p.add_argument("-e", dest="epochs", type=int, default=10,
                   help="AL iterations a user (default 10)")
    p.add_argument("-n", dest="num_anno", type=int, default=150,
                   help="users with at least this many annotations")
    p.add_argument("--models", nargs="+", default=list(MODELS))
    p.add_argument("--modes", nargs="+", default=list(MODES))
    p.add_argument("--extra", default="",
                   help="extra amg_test flags, e.g. '--max-users 2'")
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.smoke:
        with tempfile.TemporaryDirectory(prefix="reproduce-smoke-") as root:
            return smoke(root, args.device)["rc"]
    return run_pipeline(
        args.models_root, args.deam_root, args.amg_root, device=args.device,
        cv=args.cv, queries=args.queries, epochs=args.epochs,
        num_anno=args.num_anno, models=args.models, modes=args.modes,
        extra=shlex.split(args.extra))["rc"]


if __name__ == "__main__":
    sys.exit(main())
