"""The JAX package's scale-down, skewed-soak and observability gates
against the port, through ``cli/fault_matrix.py --leg NAME --device cpu``
(the port's coordinator over ``amg_test --fabric-worker`` processes on the
seeded synthetic tree, or an in-process serve cohort of its users).

- ``drain`` (``scripts/elastic_check.sh`` leg 2): a 3-host elastic fabric
  scales down mid-run; the coordinator killed at ``fabric.drain``,
  ``fabric.migrate.fence`` and ``fabric.migrate.commit`` and rerun, each
  rerun ending on 2 hosts with every user run once, to parity.
- ``skew`` (``scripts/soak_check.sh`` leg 3): the soak fabric under a
  trace whose pools hold a strict hot-size majority; zero loss, valid
  streams, percentile rows for both classes, parity.
- ``obs`` (``scripts/obs_check.sh`` legs 1-2): a traced serve cohort
  (valid metrics, orphan-free spans, the Chrome export, ``report``), then
  a traced 3-host drain and migrate with the introspection plane on
  (mid-run snapshots, a burn-rate alert, the control-plane lane
  flow-linked into the users' traces, ``top --once``).

The CLI holds each leg to its gate; each test below reads the leg's JSON
line and the files it left, and every journal and WAL replays in the JAX
package to the port's state.  The three legs run at once, each in a
process of its own: the drain leg's six incarnations are the long pole."""

import os

import pytest
import torch

from consensus_entropy_tpu.obs import export as jax_export
from consensus_entropy_tpu.serve import AdmissionJournal as JaxJournal
from consensus_entropy_tpu.workload import grade_run as jax_grade_run
from consensus_entropy_tpu.workload import load as jax_load_trace
from consensus_entropy_tpu_torch.cli.fault_matrix import DRAIN_POINTS
from tests.torch_gate_legs import (
    finishes,
    replay_in_both,
    run_legs,
    users_dirs,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.faults

#: seconds the three legs may take together before the run counts as
#: wedged (the drain leg takes about 45 s on an idle 8-core host)
LEGS_TIMEOUT_S = 360
#: the fabrics and serve cohorts each leg leaves
USERS_DIRS = {"drain": len(DRAIN_POINTS), "skew": 1, "obs": 2}
LEGS = tuple(USERS_DIRS)
N_USERS = 6


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """``{leg: (its root, its exit code, its JSON line)}``."""
    return run_legs(tmp_path_factory.mktemp("gates_scale"), LEGS,
                    LEGS_TIMEOUT_S)


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


def test_each_drain_kill_reruns_to_two_hosts_and_one_owner(legs):
    """Whichever boundary the coordinator died at, the journal holds one
    drain decision (the killed one left none, or its rerun reused it),
    the fleet ends on 2 hosts and every user ran to one finish."""
    rec = legs["drain"][2]
    assert set(rec) >= set(DRAIN_POINTS)
    for users in users_dirs(legs["drain"][0], "drain"):
        jp = os.path.join(users, "serve_journal.jsonl")
        recs = jax_export.read_jsonl_tolerant(jp)
        assert [r["event"] for r in recs].count("drain") == 1, users
        assert [r["event"] for r in recs].count("epoch") == 2, users
        with JaxJournal(jp) as j:
            assert len(j.state.fleet_hosts()) == 2
            assert len(j.state.finished) == N_USERS and not j.state.pending
        ran = finishes(users)
        assert len(ran) == N_USERS
        assert all(len(hosts) == 1 for hosts in ran.values())
    for point in DRAIN_POINTS:
        assert rec[point]["users"] == N_USERS


def test_the_skewed_soak_grades_both_classes(legs):
    """The trace's pools hold a strict hot-size majority and still draw
    the cold size; the JAX package's grader, over the port's run and the
    same trace file, finds zero loss and both classes' percentiles."""
    rec = legs["skew"][2]
    sizes = list(rec["pools"].values())
    assert len(set(sizes)) == 2
    assert rec["hot_users"] == sizes.count(rec["hot_pool"]) > N_USERS // 2 + 1
    (users,) = users_dirs(legs["skew"][0], "skew")
    trace = jax_load_trace(os.path.join(str(legs["skew"][0]),
                                        "skew_trace.jsonl"))
    g = jax_grade_run(users, journal_path=os.path.join(
        users, "serve_journal.jsonl"), trace=trace,
        slo_s={"interactive": 0.5, "batch": 600.0})
    assert g["deterministic"]["zero_loss"]
    assert g["deterministic"]["stream_ok"]
    for cls in ("interactive", "batch"):
        row = g["measured"]["per_class"][cls]
        assert row["n"] >= 1 and row["p99_s"] is not None
        assert row["n"] == rec["per_class"][cls]["n"]


def test_the_traced_runs_export_in_both_packages(legs):
    """Leg 1's spans merge with no orphan and leg 2's carry the control
    lane's drain, fence and migrate spans, read by the JAX package's
    exporter too; every metrics stream passes its schema."""
    rec = legs["obs"][2]
    live = rec["live"]
    assert live["drains"] == 1 and live["fences"] >= 1
    assert "coordinator" in live["snapshots"] and live["alerts"]
    assert {"ctl.drain", "ctl.fence", "ctl.migrate",
            "ctl.drain_done"} <= set(live["control_spans"])
    assert live["flows"] >= 1
    by_name = {os.path.basename(os.path.dirname(os.path.dirname(u))): u
               for u in users_dirs(legs["obs"][0], "obs")}
    spans = jax_export.load_spans([os.path.join(by_name["obs_trace"],
                                                "spans.jsonl")])
    assert len(spans) == rec["trace"]["spans"]
    assert jax_export.orphan_spans(spans) == []
    ctl = jax_export.load_spans([os.path.join(by_name["obs_live"],
                                              "spans.jsonl")])
    assert {"ctl.drain", "ctl.fence", "ctl.migrate"} <= {
        s["name"] for s in ctl if s.get("ctl")}
    for users in by_name.values():
        for path in jax_export.find_metrics_files(users):
            assert jax_export.validate_metrics_file(path) == [], path
