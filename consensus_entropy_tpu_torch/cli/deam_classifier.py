"""Pre-training CLI: ``deam_classifier.py -cv N -m MODEL`` on the port.

Counterpart of ``consensus_entropy_tpu/cli/deam_classifier.py:19-104``,
with the same flags and ``--device {cuda,cpu}`` (default ``cuda``: the CNN
folds train on the card; the classic kinds train on the host either way).

    python -m consensus_entropy_tpu_torch.cli.deam_classifier -cv 5 -m gnb \\
        --models-root M --deam-root D
"""

from __future__ import annotations

import argparse
import os
import sys

from consensus_entropy_tpu_torch.cli.common import (
    add_device_arg,
    add_path_args,
    resolve_cnn_config,
)


def build_parser() -> argparse.ArgumentParser:
    from consensus_entropy_tpu_torch.train.pretrain import MODEL_CHOICES

    p = argparse.ArgumentParser(
        description="Pre-train committee members on DEAM")
    p.add_argument("-cv", "--cross_val", required=True, dest="cross_val",
                   help="cross validation splits (int)")
    p.add_argument("-m", "--model", required=True, dest="model",
                   choices=MODEL_CHOICES,
                   help="model to train ('cnn' is an alias of 'cnn_jax', "
                        "the vgg ShortChunkCNN; cnn_{arch}_jax another "
                        "trunk; every classic kind, gnb, sgd, xgb, rf, svc, "
                        "knn, gpc and gbc, is fitted on the host without "
                        "scikit-learn)")
    p.add_argument("--epochs", type=int, default=None,
                   help="override CNN epochs (default settings n_epochs_cnn)")
    p.add_argument("--tb-dir", default=None,
                   help="write TensorBoard Loss/train, Loss/valid, F1 "
                        "scalars for CNN pre-training here")
    p.add_argument("--cnn-config-json", default=None, metavar="JSON",
                   help="debug: CNNConfig field overrides as a JSON object "
                        "(e.g. '{\"n_layers\": 2, \"input_length\": 1024}')")
    p.add_argument("--seed", type=int, default=1987)
    p.add_argument("--n-jobs", type=int, default=1,
                   help="process pool over classic-model CV folds (the "
                        "reference hardcodes n_jobs=10, "
                        "deam_classifier.py:326; default 1: fold results "
                        "are order-stable either way)")
    add_path_args(p)
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        cv = int(args.cross_val)
    except ValueError:
        print("Cross validation parameter must be a number!")
        return 2

    from consensus_entropy_tpu_torch.config import PathsConfig, TrainConfig
    from consensus_entropy_tpu_torch.data import deam
    from consensus_entropy_tpu_torch.device import resolve_device
    from consensus_entropy_tpu_torch.train import pretrain

    if args.model not in pretrain.CNN_MODELS:
        try:
            pretrain.check_model(args.model)
        except ValueError as e:
            print(f"cannot pre-train: {e}")
            return 1
    device = resolve_device(args.device)
    paths = PathsConfig(models_root=args.models_root,
                        deam_root=args.deam_root, amg_root=args.amg_root)
    out_dir = paths.pretrained_dir
    annotations = os.path.join(args.deam_root, "annotations")
    table = deam.load_dataset(paths.deam_features_dir,
                              os.path.join(annotations, "arousal.csv"),
                              os.path.join(annotations, "valence.csv"),
                              cache_csv=paths.deam_dataset_csv)

    if args.model in pretrain.CNN_MODELS:
        from consensus_entropy_tpu_torch.data.audio import (
            device_store_from_npy,
        )

        labels = deam.song_labels(table)
        # cnn_{arch}_jax names the trunk family, set at construction
        cfg = resolve_cnn_config(args.cnn_config_json,
                                 arch=pretrain.cnn_model_arch(args.model))
        store = device_store_from_npy(paths.deam_npy_dir, list(labels),
                                      cfg.input_length, device)
        pretrain.pretrain_cnn(labels, store, cv=cv, out_dir=out_dir,
                              config=cfg, train_config=TrainConfig(),
                              n_epochs=args.epochs, seed=args.seed,
                              tb_dir=args.tb_dir)
    else:
        X, y, song_ids = deam.training_arrays(table)
        pretrain.pretrain_classic(args.model, X, y, song_ids, cv=cv,
                                  out_dir=out_dir, seed=args.seed,
                                  n_jobs=args.n_jobs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
