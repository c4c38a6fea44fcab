"""The JAX gates' real-worker legs against the port, through
``cli/fault_matrix.py --leg NAME --device cpu``: the port's coordinator
over ``amg_test --fabric-worker`` processes on a seeded synthetic tree.

- ``elastic`` (``scripts/elastic_check.sh:5-17``): 2 elastic hosts (at
  most 3), h0 SIGKILLed at its first admission; the autoscaler's
  replacement (a ``spawn`` record, a fresh host id in the replayed fleet
  shape) leases and every surviving host ends on the fleet's merged
  planner edges.
- ``remedy`` (``scripts/remedy_check.sh:5-25``): 3 hosts, h0 slowed by a
  ``pool.score`` delay; a rebalance off h0 without retiring it, a fence
  deadline demoted to evict+resume, and the coordinator killed at
  ``fabric.remedy`` (before its record) and rerun.
- ``gray`` (``scripts/gray_check.sh:5-25``): 3 hosts, every dispatch on
  h0 held 3 s (above the detector's 2-s floor); the ladder to
  ``gray_drain`` with h0 never retired, and the coordinator killed at
  ``fabric.gray`` and rerun, the users h0 held finishing elsewhere.
- ``soak`` (``scripts/soak_check.sh:5-25``): a compressed ``workload``
  trace through ``TraceDriver(FabricTarget(coord))`` on 2 keep-open hosts
  with the burn-rate hold armed: a ``slo_headroom`` alert fired and
  graded, a journaled hold, a churn disconnect, zero loss; then the
  coordinator killed at ``fabric.remedy`` mid-soak and the rerun
  finishing every trace user exactly once.

The CLI holds each leg to its gate's conditions (every journal and WAL
valid, each user run once, each user's state its sequential run's).
Then every journal and WAL a leg left validates under the JAX package
too and replays in its ``AdmissionJournal`` to the port's state.

The four legs run at once, each CLI in a process of its own (a leg's
coordinator kills are process-wide fault rules): the legs spend most of
their time waiting on worker start-up, delays and stalls."""

import glob
import json
import os
import subprocess
import sys

import pytest
import torch

from consensus_entropy_tpu.serve import AdmissionJournal as JaxJournal
from consensus_entropy_tpu.serve import (
    validate_journal_file as jax_validate,
)
from consensus_entropy_tpu_torch.cli.fault_matrix import REAL_LEGS
from consensus_entropy_tpu_torch.serve import AdmissionJournal
from consensus_entropy_tpu_torch.serve import validate_journal_file

torch.set_num_threads(1)

pytestmark = pytest.mark.faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds the four legs may take together before the run counts as
#: wedged (each takes 12-30 s on an idle 8-core host)
LEGS_TIMEOUT_S = 240
#: the coordinator incarnations' fabrics each leg leaves
FABRICS = {"elastic": 1, "remedy": 3, "gray": 2, "soak": 2}


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """``{leg: (its root, its exit code, its JSON line)}``."""
    root = tmp_path_factory.mktemp("gates")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + (os.pathsep + os.environ["PYTHONPATH"]
                                  if os.environ.get("PYTHONPATH") else ""))
    env.pop("CETPU_FAULTS", None)
    procs = {leg: subprocess.Popen(
        [sys.executable, "-m", "consensus_entropy_tpu_torch.cli."
         "fault_matrix", "--leg", leg, "--device", "cpu", "--root",
         str(root / leg)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for leg in REAL_LEGS}
    out = {}
    try:
        for leg, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=LEGS_TIMEOUT_S)
            lines = [json.loads(line) for line in stdout.splitlines()
                     if line.startswith("{")]
            rec = lines[-1] if lines else {
                "ok": False, "error": f"no JSON line:\n{stderr[-3000:]}"}
            out[leg] = (root / leg, proc.returncode, rec)
    finally:
        # a wedged leg: its workers exit with their coordinator
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


@pytest.mark.parametrize("leg", REAL_LEGS)
def test_the_leg_passes_its_gate(legs, leg):
    _, rc, rec = legs[leg]
    assert rec["ok"], rec.get("error")
    assert rc == 0


@pytest.mark.parametrize("leg", REAL_LEGS)
def test_the_journals_replay_in_the_jax_package(legs, leg):
    """Each journal and WAL the leg left validates under both packages,
    and each replays in the JAX package's ``AdmissionJournal`` to the
    port's state."""
    # the leg's fabrics are named after it (``tree`` is the registry's)
    fabrics = sorted(glob.glob(os.path.join(str(legs[leg][0]), f"{leg}*",
                                            "models", "users")))
    assert len(fabrics) == FABRICS[leg]
    for users in fabrics:
        wals = sorted(glob.glob(os.path.join(users, "fabric",
                                             "events_*.jsonl")))
        assert wals
        for path in (os.path.join(users, "serve_journal.jsonl"), *wals):
            assert jax_validate(path) == [], path
            assert validate_journal_file(path) == [], path
            theirs, ours = JaxJournal(path), AdmissionJournal(path)
            try:
                assert theirs.state.to_dict() == ours.state.to_dict(), path
            finally:
                theirs.close()
                ours.close()


def test_the_replacement_leased(legs):
    rec = legs["elastic"][2]
    assert rec["revocations"] == 1 and "h2" in rec["fleet"]
    assert rec["served"]["h0"] == 0
    assert sum(rec["served"].values()) == rec["users"]
    assert rec["kill_to_respawn_lease_s"] > 0
    assert rec["edges"]


def test_remedy_moved_load_without_retiring(legs):
    rec = legs["remedy"][2]
    assert rec["rebalance"]["remedies"] >= 1
    assert rec["rebalance"]["migrations"] >= 1
    assert rec["deadline"]["fence_timeouts"] >= 1


def test_gray_drained_and_freed_the_hostages(legs):
    rec = legs["gray"][2]
    assert rec["ladder"]["probations"] >= 1
    assert rec["ladder"]["gray_drains"] >= 1 and rec["kill"]["hostages"]


def test_the_soak_held_and_was_killed_mid_run(legs):
    rec = legs["soak"][2]
    assert rec["soak"]["holds"] >= 1 and rec["soak"]["disconnects"] >= 1
    assert rec["soak"]["alerts"]["slo_headroom"] >= 1
    assert rec["kill"]["users"] == rec["soak"]["users"]
