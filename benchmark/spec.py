"""Finds a cell's parts by the names ``BENCHMARK.json`` gives them.

A cell (an entry of ``workloads``) names a configuration, whose file the
``configs`` entry gives, and a traffic mix, ``traffic/<name>.json``, whose
``kind`` names its driver, ``benchmark.drivers.<kind>``.  The limits its
correctness check holds the run to are ``limits/<cell>.json``, and each
per-layer metric is read by ``metrics/<metric>.py``'s ``read(ctx)``.  So a
later cell, configuration, traffic mix or metric is added as files and
entries alone.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    #: the benchmark folder the cell's files were read from
    here: pathlib.Path = HERE


def load_benchmark(path=None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, workload: str, *, root=None, here=None) -> Cell:
    """The cell named ``workload``, its files read.  ``root`` is the
    folder the configurations' paths are relative to (the repository's
    root), ``here`` the benchmark's folder."""
    root = pathlib.Path(root or REPO)
    here = pathlib.Path(here or HERE)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(here / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(here / "limits" / f"{workload}.json")
    return Cell(workload, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)],
                here)


def driver(traffic: dict):
    """The module that drives a traffic mix of this ``kind``."""
    return importlib.import_module(f"benchmark.drivers.{traffic['kind']}")


def reader(name: str, *, here=None):
    """``metrics/<name>.py``'s ``read(ctx)``: the metric's value, or
    ``None`` where the run gave it nothing to read."""
    path = pathlib.Path(here or HERE) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
