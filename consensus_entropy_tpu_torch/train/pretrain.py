"""DEAM pre-training: the committee registry the AL loop personalizes.

Counterpart of ``consensus_entropy_tpu/train/pretrain.py:38-280``
(``deam_classifier.py:179-350``): grouped cross-validation keeping every
fold's estimator as a committee member (``-cv 5`` gives 5 members of a
kind, paper section 3.3), and per-fold CNN training.  Files are the port's
``.npz`` members, named as the JAX package names its pickles and
checkpoints (``classifier_{model}.it_{i}``, ``classifier_cnn.it_{i}`` or
``classifier_cnn_{arch}.it_{i}``), metrics are printed and appended to
``pretrain_metrics.jsonl``.

The registry holds every kind of the JAX registry
(``consensus_entropy_tpu/train/pretrain.py:38-63``), with its settings,
and fits each without scikit-learn, which the card machine lacks:
``gnb`` and ``sgd`` (``models/members.py``), ``xgb`` (the boosted trees of
``models/gbdt.py``, the member the JAX slot takes without xgboost) and the
frozen generic kinds ``rf``, ``svc``, ``knn``, ``gpc`` and ``gbc``
(``models/generic_members.py``: scikit-learn 1.9.0's forest, libsvm's
SVC, the stored rows, the Laplace GPC and the gradient boosting, fitted
in the host core and numpy/scipy as its docstring says).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Callable

import numpy as np
import torch

from consensus_entropy_tpu_torch.al.reporting import weighted_f1, weighted_prf
from consensus_entropy_tpu_torch.config import (
    CNN_ARCHS,
    CNNConfig,
    TrainConfig,
)
from consensus_entropy_tpu_torch.models.base import Member


def cnn_model_name(arch: str) -> str:
    """The model name that pre-trains trunk family ``arch``: ``cnn_jax``
    for vgg, ``cnn_{arch}_jax`` for the others."""
    return "cnn_jax" if arch == "vgg" else f"cnn_{arch}_jax"


#: model names that pre-train CNN folds (``cnn`` is ``cnn_jax``'s alias)
CNN_MODELS = ("cnn", *(cnn_model_name(a) for a in CNN_ARCHS))
MODEL_CHOICES = ("gnb", "sgd", "xgb", "rf", "svc", "knn", "gpc", "gbc",
                 *CNN_MODELS)


def cnn_model_arch(model: str) -> str | None:
    """The trunk family a ``cnn_{arch}_jax`` name sets; ``None`` for
    ``cnn``/``cnn_jax``, whose family is the configuration's."""
    if model not in CNN_MODELS:
        raise ValueError(f"{model!r} pre-trains no CNN")
    return None if model in ("cnn", "cnn_jax") else model[len("cnn_"):-4]


def _registry(seed) -> dict[str, Callable[[str], Member]]:
    from consensus_entropy_tpu_torch.models.gbdt import NativeGBDTMember
    from consensus_entropy_tpu_torch.models.generic_members import (
        GenericMember,
    )
    from consensus_entropy_tpu_torch.models.members import (
        GNBMember,
        SGDMember,
    )

    return {
        "gnb": lambda name: GNBMember(name),
        "sgd": lambda name: SGDMember(name, seed=seed),
        # 100 rounds at depth 5; its trees draw nothing (JAX: seed or 0)
        "xgb": lambda name: NativeGBDTMember(name),
        # RandomForestClassifier(random_state=seed, warm_start=True)
        "rf": lambda name: GenericMember(name, "rf", seed=seed),
        # SVC(probability=True, random_state=seed)
        "svc": lambda name: GenericMember(name, "svc", seed=seed),
        # KNeighborsClassifier(): k = 5, its fit stores the rows
        "knn": lambda name: GenericMember(name, "knn"),
        # GaussianProcessClassifier(kernel=1.0 * RBF(1.0),
        # random_state=seed, warm_start=True)
        "gpc": lambda name: GenericMember(name, "gpc", seed=seed),
        # GradientBoostingClassifier(max_depth=2, random_state=seed,
        # warm_start=True)
        "gbc": lambda name: GenericMember(name, "gbc", seed=seed),
    }


def check_model(model: str) -> None:
    """Raise for a name that is no classic kind of the registry."""
    if model not in _registry(None):
        raise ValueError(f"unknown classic model {model!r}")


def grouped_folds(song_ids, n_splits: int, rng: np.random.Generator,
                  test_size: float = 0.2):
    """``GroupShuffleSplit`` semantics (``deam_classifier.py:199``):
    ``n_splits`` independent shuffles of the songs, ``test_size`` of them
    held out; yields ``(train rows, test rows)``."""
    songs = np.unique(song_ids)
    for _ in range(n_splits):
        perm = rng.permutation(len(songs))
        n_test = max(1, int(round(test_size * len(songs))))
        test_songs = set(songs[perm[:n_test]])
        test_mask = np.array([s in test_songs for s in song_ids])
        yield np.flatnonzero(~test_mask), np.flatnonzero(test_mask)


def _fit_fold(model: str, seed, i: int, X_tr, y_tr, X_te, y_te):
    """One fold's member and its weighted (precision, recall, F1) on the
    held-out songs' frames; a worker process runs it as is."""
    member = _registry(seed)[model](f"it_{i}")
    member.fit(X_tr, y_tr)
    return member, weighted_prf(y_te, member.predict(X_te))


def _limit_worker_threads(n: int) -> None:
    from consensus_entropy_tpu_torch import native

    native.limit_threads(n)


def pretrain_classic(model: str, X, y, song_ids, *, cv: int,
                     out_dir: str, seed: int = 1987,
                     n_jobs: int = 1) -> dict:
    """Train ``cv`` fold members of ``model``, saved as
    ``classifier_{model}.it_{i}.npz`` (``deam_classifier.py:331-333``).

    ``n_jobs != 1`` trains folds in a pool of ``n_jobs`` processes (one a
    fold when ``n_jobs <= 0``) started by ``spawn`` (never ``fork``: the
    parent may hold CUDA and threads), each worker's
    OpenMP team capped at its share of the cores; results come back in
    fold order, so files and metrics equal the sequential run's."""
    check_model(model)
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    folds = list(enumerate(grouped_folds(song_ids, cv, rng)))
    jobs = [(model, seed, i, X[tr], y[tr], X[te], y[te])
            for i, (tr, te) in folds]
    if n_jobs != 1 and len(folds) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        workers = min(n_jobs if n_jobs > 0 else len(folds), len(folds))
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=_limit_worker_threads,
                initargs=(max(1, (os.cpu_count() or 1) // workers),)
        ) as pool:
            futures = [pool.submit(_fit_fold, *job) for job in jobs]
            fitted = [f.result() for f in futures]
    else:
        fitted = [_fit_fold(*job) for job in jobs]

    scores = {"precision": [], "recall": [], "f1": []}
    for member, (p, r, f1) in fitted:
        scores["precision"].append(p)
        scores["recall"].append(r)
        scores["f1"].append(f1)
        member.save(os.path.join(out_dir,
                                 f"classifier_{model}.{member.name}.npz"))
    summary = {k: {"mean": float(np.mean(v)), "std": float(np.std(v))}
               for k, v in scores.items()}
    _print_cv(summary)
    _append_jsonl(out_dir, {"model": model, "cv": cv, **summary,
                            "fold_f1": [round(float(v), 4)
                                        for v in scores["f1"]]})
    return summary


def _fingerprint(config: CNNConfig, n_epochs, seed, fold: int,
                 n_train: int) -> dict:
    """The resume fingerprint a fold file's header carries."""
    from consensus_entropy_tpu_torch.models.committee import CNNMember

    return {"n_epochs": n_epochs, "seed": seed, "fold": fold,
            "n_train_songs": n_train,
            **{k: getattr(config, k) for k in CNNMember.FRONTEND_META}}


def pretrain_cnn(song_labels: dict, store, *, cv: int, out_dir: str,
                 config: CNNConfig = CNNConfig(),
                 train_config: TrainConfig = TrainConfig(),
                 n_epochs: int | None = None, seed: int = 1987,
                 tb_dir: str | None = None, resume: bool = False) -> dict:
    """Per-fold CNN training (``deam_classifier.py:249-316``) on ``store``'s
    device, each fold saved as ``classifier_cnn.it_{i}.npz`` (a non-vgg
    trunk: ``classifier_cnn_{arch}.it_{i}.npz``).

    Fold ``i`` draws under ``prng.key(seed + i)``: ``fold_in`` 0 for the
    initial variables, 1 for ``fit`` (Adam patience 40,
    ``deam_classifier.py:150``), 2 for the evaluation crops, one a test
    song, forwarded 64 at a time.  ``resume=True`` skips a fold whose file
    exists and whose header's fingerprint (epochs, seed, fold, train songs,
    frontend) matches this call, and raises on a mismatch.  ``tb_dir``
    writes the reference's TensorBoard scalars where
    ``torch.utils.tensorboard`` imports."""
    from consensus_entropy_tpu_torch import prng
    from consensus_entropy_tpu_torch.labels import one_hot_np
    from consensus_entropy_tpu_torch.models import short_cnn
    from consensus_entropy_tpu_torch.models.base import _read_npz
    from consensus_entropy_tpu_torch.models.cnn_trainer import CNNTrainer
    from consensus_entropy_tpu_torch.models.committee import CNNMember

    os.makedirs(out_dir, exist_ok=True)
    writer = _tensorboard_writer() if tb_dir else None
    dev = store.device
    rng = np.random.default_rng(seed)
    songs = np.array(list(song_labels.keys()), dtype=object)
    trainer = CNNTrainer(config, train_config)
    stem = CNNMember.file_stem(config.arch)
    f1s = []
    for i, (tr, te) in enumerate(grouped_folds(songs, cv, rng)):
        key = prng.key(seed + i, dev)
        train_ids = [songs[j] for j in tr]
        test_ids = [songs[j] for j in te]
        y_tr = one_hot_np([song_labels[s] for s in train_ids])
        y_te = one_hot_np([song_labels[s] for s in test_ids])
        fold_path = os.path.join(out_dir, f"classifier_{stem}.it_{i}.npz")
        want = _fingerprint(config, n_epochs, seed, i, len(train_ids))
        if resume and os.path.exists(fold_path):
            # the folds' splits come from the rng's sequence, so skipping a
            # saved fold leaves every later fold's split and keys as they
            # were; the header must name this very call
            meta, _ = _read_npz(fold_path)
            mismatch = {k: (meta.get(k), v) for k, v in want.items()
                        if meta.get(k) != v}
            if mismatch:
                raise ValueError(
                    f"{fold_path} exists but its fingerprint does not "
                    f"match this pretraining call: {mismatch}; delete the "
                    "stale file or run without resume")
            print(f"fold {i}: resuming from {fold_path}")
            best = CNNMember.load(fold_path, config, dev).variables
            hist = []
        else:
            variables = short_cnn.init_variables(prng.fold_in(key, 0),
                                                 config, dev)
            best, hist = trainer.fit(
                variables, store, train_ids, y_tr, test_ids, y_te,
                prng.fold_in(key, 1), n_epochs=n_epochs, adam_patience=40)
            CNNMember(f"it_{i}", best, config).save(fold_path, meta=want)
        # one crop a test song, forwarded in bounded chunks, the last crop
        # repeated to fill the final chunk
        crops = store.sample_crops(prng.fold_in(key, 2),
                                   store.row_of(test_ids))
        chunk = 64
        pad = -len(crops) % chunk
        if pad:
            crops = torch.cat([crops, crops[-1:].expand(pad, -1)])
        with torch.no_grad():
            preds = np.concatenate(
                [short_cnn.apply_infer(best, crops[lo: lo + chunk], config)
                 .cpu().numpy() for lo in range(0, crops.shape[0], chunk)])
        preds = preds[: len(test_ids)].argmax(axis=1)
        f1s.append(weighted_f1(y_te.argmax(axis=1), preds))
        if writer is not None:
            _write_tensorboard(writer, os.path.join(tb_dir, f"fold_{i}"),
                               hist, f1s[-1])
    summary = {"f1": {"mean": float(np.mean(f1s)), "std": float(np.std(f1s))}}
    _print_cv(summary)
    _append_jsonl(out_dir, {"model": cnn_model_name(config.arch),
                            "cv": cv, "arch": config.arch, **summary,
                            "fold_f1": [round(float(v), 4) for v in f1s]})
    return summary


def _tensorboard_writer():
    """``SummaryWriter``, or ``None`` (said once on stderr) where
    ``torch.utils.tensorboard`` does not import (it needs the tensorboard
    package); ``pretrain_metrics.jsonl`` carries the same numbers."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        print(f"--tb-dir: no TensorBoard scalars ({e}); "
              "pretrain_metrics.jsonl has the fold F1s", file=sys.stderr)
        return None
    return SummaryWriter


def _write_tensorboard(writer, run_dir: str, history: list[dict],
                       f1: float) -> None:
    """The reference's scalars: ``Loss/train``, ``Loss/valid`` and
    ``F1/valid`` per epoch, the fold's ``F1/fold``."""
    with writer(run_dir) as w:
        for rec in history:
            w.add_scalar("Loss/train", rec["train_loss"], rec["epoch"])
            w.add_scalar("Loss/valid", rec["val_loss"], rec["epoch"])
            w.add_scalar("F1/valid", rec["val_f1"], rec["epoch"])
        w.add_scalar("F1/fold", f1, len(history))


def _print_cv(summary: dict) -> None:
    print("\n*-*-*-*-*-*-*-\n CV RESULTS\n*-*-*-*-*-*-*-")
    for metric, s in summary.items():
        print("{}: {:.3f} ± {:.3f} ({:.3f})".format(
            metric.upper(), s["mean"], 2 * s["std"], s["std"]))


def _append_jsonl(out_dir: str, record: dict) -> None:
    with open(os.path.join(out_dir, "pretrain_metrics.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")
