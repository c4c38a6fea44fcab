"""Shared CLI plumbing: device selection, path flags and the CNN config."""

from __future__ import annotations

import argparse


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the acquisition, the device members and "
                             "the CNN members run: the card (default), or "
                             "the CPU, which runs the kernels' plain PyTorch "
                             "versions")


def add_path_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--models-root", default="./models",
                        help="model store root (settings.py:11)")
    parser.add_argument("--deam-root", default="./data/deam",
                        help="DEAM dataset root (settings.py:17-21)")
    parser.add_argument("--amg-root", default="./data/amg1608",
                        help="AMG1608 dataset root (settings.py:27-33)")


def resolve_cnn_config(cnn_config_json: str | None, *,
                       arch: str | None = None):
    """``CNNConfig`` from the ``--cnn-config-json`` field overrides (or
    the defaults), with ``arch`` from ``--cnn-arch`` or the model name
    set at construction (the geometry check depends on it)."""
    import json

    from consensus_entropy_tpu_torch.config import CNNConfig

    kw = json.loads(cnn_config_json) if cnn_config_json else {}
    if arch is not None:
        if kw.get("arch", arch) != arch:
            raise ValueError(
                f"--cnn-config-json sets arch={kw['arch']!r} but the "
                f"model or --cnn-arch selects {arch!r}; drop one of them")
        kw["arch"] = arch
    return CNNConfig(**kw)
