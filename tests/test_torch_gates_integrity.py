"""The JAX package's storage-integrity, mesh and SLO gates against the
port, through ``cli/fault_matrix.py --leg NAME --device cpu`` (the port's
coordinator over ``amg_test --fabric-worker`` processes on the seeded
synthetic tree, or an in-process serve cohort of its users).

- ``fsck`` (``scripts/fsck_check.sh`` legs 1 and 2a): a full 2-host run
  to parity; one byte of a mid-file framed ``enqueue`` record flipped
  halts replay; ``fsck`` exits 1, ``--repair`` quarantines the line and
  sweeps a planted ``.tmp``, ``fsck`` exits 0 and the journal replays
  every disposition; a second incarnation claims epoch 2 and re-runs
  nothing.
- ``mesh`` (``scripts/mesh_check.sh`` leg 2): h0 serves through a 4-way
  pool mesh (four ``cpu`` entries here) and is SIGKILLed at its first
  admission; every user finishes on the 1-device h1 with its sequential
  run's state.
- ``slo`` (``scripts/slo_check.sh``): a planner-enabled 2-class serve
  cohort; valid metrics, per-class histograms, the planner's events, and
  the live bucket edges derived again from the replayed journal.

The CLI holds each leg to its gate; each test below reads the leg's JSON
line and the files it left, and every journal and WAL replays in the JAX
package to the port's state.  The three legs run at once, each in a
process of its own."""

import json
import os

import pytest
import torch

from consensus_entropy_tpu.obs import export as jax_export
from consensus_entropy_tpu.serve import AdmissionJournal as JaxJournal
from consensus_entropy_tpu.serve import AdmissionPlanner as JaxPlanner
from consensus_entropy_tpu.serve import BucketRouter as JaxRouter
from consensus_entropy_tpu.serve import ServeConfig as JaxServeConfig
from consensus_entropy_tpu_torch.cli.fault_matrix import (
    MESH_DEVICES,
    SLO_SERVE,
)
from tests.torch_gate_legs import (
    finishes,
    replay_in_both,
    run_legs,
    users_dirs,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.faults

#: seconds the three legs may take together before the run counts as
#: wedged (each takes 5-15 s on an idle 8-core host)
LEGS_TIMEOUT_S = 240
#: the fabrics and serve cohorts each leg leaves
USERS_DIRS = {"fsck": 1, "mesh": 1, "slo": 1}
LEGS = tuple(USERS_DIRS)
N_USERS = 6


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """``{leg: (its root, its exit code, its JSON line)}``."""
    return run_legs(tmp_path_factory.mktemp("gates_integrity"), LEGS,
                    LEGS_TIMEOUT_S)


def _users(legs, leg):
    (users,) = users_dirs(legs[leg][0], leg)
    return users


@pytest.mark.parametrize("leg", LEGS)
def test_the_leg_passes_its_gate(legs, leg):
    _, rc, rec = legs[leg]
    assert rec["ok"], rec.get("error")
    assert rc == 0


@pytest.mark.parametrize("leg", LEGS)
def test_the_journals_replay_in_the_jax_package(legs, leg):
    """Each journal and WAL the leg left validates under both packages,
    and each replays in the JAX package's ``AdmissionJournal`` to the
    port's state."""
    dirs = users_dirs(legs[leg][0], leg)
    assert len(dirs) == USERS_DIRS[leg]
    for users in dirs:
        replay_in_both(users)


def test_a_flipped_byte_halts_replay_and_is_quarantined(legs):
    rec = legs["fsck"][2]
    assert rec["fsck_exits"] == [1, 0, 0]
    assert rec["flipped_line"] >= 3
    jp = os.path.join(_users(legs, "fsck"), "serve_journal.jsonl")
    # the quarantined line is the flipped one, no longer a valid frame
    with open(jp + ".quarantine", "rb") as f:
        body = f.read()
    assert body and not os.path.exists(jp + ".tmp")
    with JaxJournal(jp) as j:
        assert j.state.finished == {str(u) for u in range(N_USERS)}


def test_a_second_incarnation_claims_epoch_two_and_reruns_nothing(legs):
    rec = legs["fsck"][2]
    assert rec["epochs"] == [1, 2]
    users = _users(legs, "fsck")
    jp = os.path.join(users, "serve_journal.jsonl")
    epochs = [r["epoch"] for r in jax_export.read_jsonl_tolerant(jp)
              if r.get("event") == "epoch"]
    assert epochs == [1, 2]
    with JaxJournal(jp) as j:
        assert j.state.coordinator_epoch == 2
    ran = finishes(users)
    assert sorted(ran, key=int) == [str(u) for u in range(N_USERS)]
    assert all(len(hosts) == 1 for hosts in ran.values())


def test_the_mesh_host_fails_over_to_the_narrow_survivor(legs):
    rec = legs["mesh"][2]
    assert tuple(rec["devices"]) == MESH_DEVICES
    assert rec["revocations"] == 1 and rec["kill_to_revoke_s"] > 0
    users = _users(legs, "mesh")
    ran = finishes(users)
    assert sorted(ran, key=int) == [str(u) for u in range(N_USERS)]
    assert all(hosts == ["h1"] for hosts in ran.values())
    with JaxJournal(os.path.join(users, "serve_journal.jsonl")) as j:
        assert j.state.hosts["h0"] == "revoke"
    # h0's worker really scored on its 4-entry mesh before the kill
    with open(os.path.join(users, "fabric", "log_h0.txt")) as f:
        assert f"Scoring mesh: {MESH_DEVICES[0]} device(s)" in f.read()


def test_the_planner_edges_replay_in_both_packages(legs):
    """The live edges come back from the port's journal in the port (the
    leg's own check) and in the JAX package's planner; the metrics stream
    validates under the JAX package's schema too."""
    rec = legs["slo"][2]
    assert rec["edges"] and rec["planner_edges_events"] >= 1
    assert rec["per_class_n"] == {"batch": 3, "interactive": 3}
    users = _users(legs, "slo")
    assert jax_export.validate_metrics_file(
        os.path.join(users, "fleet_metrics.jsonl")) == []
    with JaxJournal(os.path.join(users, "serve_journal.jsonl")) as j:
        router = JaxRouter()
        planner = JaxPlanner(JaxServeConfig(**SLO_SERVE), router=router,
                             journal=j)
        assert list(planner.edges) == rec["edges"]
        assert sorted(set(j.state.classes.values())) == ["batch",
                                                        "interactive"]
    summary = [e for e in jax_export.read_jsonl_tolerant(
        os.path.join(users, "fleet_metrics.jsonl"))
        if e.get("event") == "fleet_summary"]
    assert json.loads(json.dumps(summary[-1]["planner"]["edges"])) \
        == rec["edges"]
