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

import pytest
import torch

from tests.torch_gate_legs import replay_in_both, run_legs, users_dirs

torch.set_num_threads(1)

pytestmark = pytest.mark.faults

#: seconds the four legs may take together before the run counts as
#: wedged (each takes 12-30 s on an idle 8-core host)
LEGS_TIMEOUT_S = 240
#: the coordinator incarnations' fabrics each leg leaves
FABRICS = {"elastic": 1, "remedy": 3, "gray": 2, "soak": 2}
LEGS = tuple(FABRICS)


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """``{leg: (its root, its exit code, its JSON line)}``."""
    return run_legs(tmp_path_factory.mktemp("gates"), LEGS, LEGS_TIMEOUT_S)


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
    fabrics = users_dirs(legs[leg][0], leg)
    assert len(fabrics) == FABRICS[leg]
    for users in fabrics:
        # the journal and at least one host's WAL
        assert len(replay_in_both(users)) >= 2


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
