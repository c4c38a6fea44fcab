"""Tests of the benchmark.  Run from the repository's root:

    python -m pytest benchmark/tests -q

Tests marked ``card`` need a CUDA device and skip without one (decided in
the ``card`` fixture, never at import).  On the card:
``python -m pytest benchmark/tests -q -m card``.
"""

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def add_cell(root: pathlib.Path, traffic: str = "tiny-cohort",
             name: str = "tiny.cohort2-mc"):
    """A copy of the benchmark under ``root`` with one more cell added
    as files and entries alone: the tiny configuration, a traffic mix and
    its limits.  Returns ``(BENCHMARK.json's dict, benchmark folder)``."""
    here = root / "benchmark"
    shutil.copytree(REPO / "benchmark", here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(FIXTURES / "tiny.json", here / "configs" / "tiny.json")
    shutil.copy(FIXTURES / f"{traffic}.json",
                here / "traffic" / f"{traffic}.json")
    shutil.copy(FIXTURES / "tiny-limits.json",
                here / "limits" / f"{name}.json")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": "tiny",
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench, here
