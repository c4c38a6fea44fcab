"""Shared CLI plumbing: device selection and path flags."""

from __future__ import annotations

import argparse


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the acquisition and the device members "
                             "run: the card (default), or the CPU, which "
                             "runs the kernels' plain PyTorch versions")


def add_path_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--models-root", default="./models",
                        help="model store root (settings.py:11)")
    parser.add_argument("--amg-root", default="./data/amg1608",
                        help="AMG1608 dataset root (settings.py:27-33)")
