"""The port stands alone: it imports no JAX, nothing of the JAX package and
neither scikit-learn nor pandas (the card machine has neither), and it
never falls back to the CPU on its own."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from consensus_entropy_tpu_torch import convert, prng, resolve_device
from consensus_entropy_tpu_torch.al.acquisition import Acquirer
from consensus_entropy_tpu_torch.al.linear_pool import LinearPoolScorer
from consensus_entropy_tpu_torch.al.loop import ALLoop
from consensus_entropy_tpu_torch.config import ALConfig, CNNConfig
from consensus_entropy_tpu_torch.data.audio import (
    DeviceWaveformStore,
    HostWaveformStore,
)
from consensus_entropy_tpu_torch.fleet import FleetScheduler
from consensus_entropy_tpu_torch.models import short_cnn
from consensus_entropy_tpu_torch.models.committee import CNNMember, Committee

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "consensus_entropy_tpu_torch")

#: what the port never imports
BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack",
          "consensus_entropy_tpu", "sklearn", "pandas", "joblib")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
for name in {BANNED!r}:
    sys.modules[name] = None          # any import of them now fails
import consensus_entropy_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m.split(".")[0] in {BANNED!r}))
assert not leaked, leaked
print(" ".join(names))
print(len(names))
"""

#: modules of the slices that must stay in the walk (slice 6: the harmonic
#: frontend, the trunks, full-song scoring and the reference importer;
#: slice 7: the fleet engine and the obs pieces it imports; slice 8:
#: pre-training and the evidence experiment; slice 9: the meshes; slice
#: 10: single-host serving, the span tracer, export and the workload;
#: slice 11: the fabric; slice 12: the operator plane and CLIs and the
#: generic members; slice 14: the static analysis, the race driver and the
#: reproduction pipeline)
SLICE_MODULES = ("ops.harmonic", "models.short_cnn", "data.audio",
                 "models.committee", "convert", "prng", "cli.amg_test",
                 "fleet.scheduler", "fleet.report", "fleet.session",
                 "obs.trace", "obs.metrics",
                 "ops.scoring", "models.cnn_trainer", "data.deam",
                 "train.pretrain", "cli.deam_classifier", "al.evidence",
                 "cli.evidence", "parallel.mesh", "parallel.sharding",
                 "parallel.pool_mesh", "parallel.sequence",
                 "parallel.multihost", "serve.buckets", "serve.breaker",
                 "serve.watchdog", "serve.planner", "serve.journal",
                 "serve.server", "obs.export", "resilience.io",
                 "workload.trace", "workload.driver", "workload.grade",
                 "serve.fabric", "serve.hosts", "obs.alerts", "obs.status",
                 "cli.top", "cli.fsck", "cli.report", "cli.soak",
                 "models.generic_members", "analysis", "analysis.engine",
                 "analysis.model", "analysis.rules", "analysis.cli",
                 "analysis.__main__", "cli.race_check", "cli.reproduce",
                 "data.synth")


def test_every_port_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 61   # the walk found the modules
    walked = set(out.stdout.split())
    for name in SLICE_MODULES:
        assert f"consensus_entropy_tpu_torch.{name}" in walked, name


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_sources():
    for root, _, files in os.walk(PORT):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_jax_package_import_in_port_or_chip_smoke():
    sources = list(_port_sources())
    assert len(sources) >= 63
    assert os.path.join(PORT, "ops", "harmonic.py") in sources
    assert os.path.join(PORT, "fleet", "scheduler.py") in sources
    for path in sources:
        for name in _imported_roots(path):
            assert name.split(".")[0] not in BANNED, (path, name)


def test_default_device_is_the_card_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        LinearPoolScorer([[[0.0]]], [[[0.0]]], [[0.0]])
    with pytest.raises(RuntimeError):
        Acquirer([1, 2], None, queries=1, mode="mc")
    with pytest.raises(RuntimeError):
        prng.key(0)
    with pytest.raises(RuntimeError):
        Committee([], device_members=True)
    with pytest.raises(RuntimeError):
        ALLoop(ALConfig())
    with pytest.raises(RuntimeError):
        FleetScheduler(ALConfig())
    with pytest.raises(RuntimeError):
        convert.key_from_jax([0, 1])
    with pytest.raises(RuntimeError):
        convert.device_members_from_numpy(*[[[[0.0]]]] * 2, [[0.0]],
                                          [[[0.0]]], [[0.0]])
    # the CNN path: its store, members' variables and committee
    cfg = CNNConfig(n_channels=4, n_mels=32, n_layers=5, input_length=8192)
    with pytest.raises(RuntimeError):
        DeviceWaveformStore({"a": np.zeros(8192, np.float32)}, 8192)
    with pytest.raises(RuntimeError):
        short_cnn.init_variables(prng.key(0, "cpu"), cfg)
    member = CNNMember("c", short_cnn.init_variables(prng.key(0, "cpu"), cfg,
                                                     "cpu"), cfg)
    with pytest.raises(RuntimeError):
        Committee([], [member], cfg)
    # slice 6: the other trunks' members and the host store
    res = CNNConfig(n_channels=4, n_mels=32, n_layers=5, input_length=8192,
                    arch="res")
    with pytest.raises(RuntimeError):
        short_cnn.init_variables(prng.key(0, "cpu"), res)
    with pytest.raises(RuntimeError):
        HostWaveformStore(str(tmp_path), [], 8192)
    # slice 10: serving runs its engine on the card, the CLI's too
    from consensus_entropy_tpu_torch.cli import amg_test
    from consensus_entropy_tpu_torch.serve import FleetServer, ServeConfig

    with pytest.raises(RuntimeError):
        FleetServer(FleetScheduler(ALConfig(), scoring_by_width=True),
                    ServeConfig())
    with pytest.raises(RuntimeError):
        amg_test.main(["-q", "2", "-e", "1", "-m", "mc", "-n", "1",
                       "--serve", "2", "--models-root", str(tmp_path)])
    assert resolve_device("cpu") == torch.device("cpu")
