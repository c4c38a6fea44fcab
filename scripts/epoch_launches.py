"""Count what a CNN member-epoch launches on the card, eager and graphed.

    python3 scripts/epoch_launches.py [--out launches.json]

One member of the benchmark's ``paper-vgg`` configuration (published
widths, float32 with TF32 off) retrains on 10 songs of a seeded store
(batch 5) and validates on 60, as in the ``vgg.cohort4-mc`` cell.  Under
``torch.profiler`` (CPU and CUDA activity) it counts:

- ``eager``: the runtime launches (kernels, copies, sets) of a 10-epoch
  fit on a slot that never captures (every epoch launched op by op), and
  those of one member-epoch split into the draws (the
  ``prng`` calls), the validation (``apply_infer``, its loss and F1) and
  the steps (the rest: the training steps, the optimizer, the gate);
- ``graphed``: the same for the first fit of a signature, whose first
  epoch runs eagerly on the slot before the capture (its launches are the
  graph's nodes, split alike), the launches a later fit makes, and the
  device kernels of one replay.

It needs a CUDA device; it prints one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from consensus_entropy_tpu_torch import prng  # noqa: E402
from consensus_entropy_tpu_torch.config import (  # noqa: E402
    CNNConfig,
    TrainConfig,
)
from consensus_entropy_tpu_torch.data.audio import (  # noqa: E402
    DeviceWaveformStore,
)
from consensus_entropy_tpu_torch.labels import one_hot_np  # noqa: E402
from consensus_entropy_tpu_torch.models import (  # noqa: E402
    cnn_trainer,
    epoch_graph,
    short_cnn,
)

CATEGORIES = ("draws", "validation")
DRAW_FNS = ("split", "permutation", "uniform", "bernoulli", "fold_in",
            "fold_in_static")
VALIDATION = ((short_cnn, "apply_infer"), (cnn_trainer, "bce_loss"),
              (cnn_trainer, "weighted_f1_in_graph"))
N_EPOCHS, N_TRAIN, N_TEST, SONGS = 10, 10, 60, 80


def _ranged(name, fn):
    def wrapped(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)
    return wrapped


@contextlib.contextmanager
def _marked():
    """Each draw, validation call, epoch, slot epoch and capture inside a
    ``record_function`` range named for it."""
    saved = []

    def patch(obj, attr, name):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, _ranged(name, getattr(obj, attr)))

    for f in DRAW_FNS:
        patch(prng, f, "cat:draws")
    for mod, f in VALIDATION:
        patch(mod, f, "cat:validation")
    patch(cnn_trainer.CNNTrainer, "_epoch", "cat:epoch")
    patch(epoch_graph.Slot, "_body", "cat:body")
    patch(epoch_graph.Slot, "_capture", "cat:capture")
    try:
        yield
    finally:
        for obj, attr, fn in reversed(saved):
            setattr(obj, attr, fn)


def _is_launch(name: str) -> bool:
    return name.startswith("cu") and any(
        w in name for w in ("Launch", "Memcpy", "Memset"))


def _count(prof) -> dict:
    """Runtime launches by the ranges that cover them (time alone: the
    backward's launches come from autograd's thread while the fitting
    thread waits inside its range), and the device's kernels."""
    events = prof.profiler.kineto_results.events()
    ranges = {}
    for e in events:
        # the host's ranges: the device timeline's copies of them run later
        if e.is_user_annotation() and e.name().startswith("cat:") and \
                e.device_type() == torch.autograd.DeviceType.CPU:
            ranges.setdefault(e.name()[4:], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))

    def inside(name, t):
        return any(lo <= t <= hi for lo, hi in ranges.get(name, ()))

    out = {"launches": 0, "graph_launches": 0, "kernels": 0,
           "epochs": len(ranges.get("epoch", ())),
           "bodies": len(ranges.get("body", ())),
           "captures": len(ranges.get("capture", ()))}
    split = {}
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CPU:
            if not e.is_user_annotation():
                out["kernels"] += 1
            continue
        if not _is_launch(e.name()):
            continue
        t = e.start_ns()
        out["launches"] += 1
        out["graph_launches"] += "GraphLaunch" in e.name()
        where = ("capture" if inside("capture", t) else
                 "body" if inside("body", t) else
                 "epoch" if inside("epoch", t) else "fit")
        cat = next((c for c in CATEGORIES if inside(c, t)), "steps") \
            if where != "fit" else "-"
        split.setdefault(where, {}).setdefault(cat, 0)
        split[where][cat] += 1
    out["split"] = split
    return out


def _profiled(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _count(prof)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cfg, tc = CNNConfig(), TrainConfig(batch_size=5)
    rng = np.random.default_rng(0)
    waves = {f"s{i}": (0.1 * rng.standard_normal(30 * 16000)).astype(
        np.float32) for i in range(SONGS)}
    store = DeviceWaveformStore(waves, cfg.input_length, "cuda")
    ids = list(waves)
    y = one_hot_np(rng.integers(0, 4, SONGS))
    start = short_cnn.init_variables(prng.key(1, "cpu"), cfg, "cuda")

    def fit(trainer, seed):
        return trainer.fit(start, store, ids[:N_TRAIN], y[:N_TRAIN],
                           ids[N_TRAIN:N_TRAIN + N_TEST],
                           y[N_TRAIN:N_TRAIN + N_TEST],
                           prng.key(seed, "cpu"), n_epochs=N_EPOCHS)

    eager = cnn_trainer.CNNTrainer(cfg, tc)
    eager.graphs = epoch_graph.EpochGraphs()
    eager.graphs.captures_on = lambda device: False
    graphed = cnn_trainer.CNNTrainer(cfg, tc)
    graphed.graphs = epoch_graph.EpochGraphs()
    fit(eager, 2)  # cuDNN's and the caches' first calls
    with _marked():
        out = {"eager": _profiled(lambda: fit(eager, 3)),
               "graphed_first": _profiled(lambda: fit(graphed, 3)),
               "graphed_next": _profiled(lambda: fit(graphed, 4))}
    slot, = graphed.graphs.slots.values()
    slot.ctr.zero_()  # the history row a replay writes
    out["replay"] = _profiled(lambda: slot.graphs["adam"].replay())
    out["captures"] = graphed.graphs.captures
    out["device"] = {"kind": torch.cuda.get_device_name(0),
                     "torch": torch.__version__}
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
