"""The port's ``FleetServer`` against its sequential loop and the JAX
package's ``FleetServer``, on the CPU.

Users of GaussianNB + SGD committees (fitted by scikit-learn, carried
across by ``convert``; the helpers of ``test_torch_fleet.py``) are served
by the port's server and by the JAX server.  For mc, hc, mix and rand each
user's trajectory, ``metrics.jsonl`` and ``al_state.json`` equal its
sequential ``ALLoop`` run's, and its queried songs and F1s equal the JAX
server's (tolerance 0: the same statements on the same values; padding to
a bucket changes no selection).  Then the fault domain and the admission
policy: bucket parity across skewed pools, eviction and resume at the
admitted width, backoff re-admission and the poison list, the breaker's
degrade and recovery, the watchdog's eviction of a hung host step, a
drain that leaves the queue untouched, a kill at
``serve.journal.append`` restarted from the journal with no user lost,
spans without orphans, and a 2-way pool mesh over the CPU."""

import copy
import dataclasses
import json

import pytest
import torch

from consensus_entropy_tpu.al.loop import UserData as JaxUserData
from consensus_entropy_tpu.config import ALConfig as JaxConfig
from consensus_entropy_tpu.fleet import FleetReport as JaxReport
from consensus_entropy_tpu.fleet import FleetScheduler as JaxScheduler
from consensus_entropy_tpu.fleet import FleetUser as JaxUser
from consensus_entropy_tpu.models.committee import Committee as JaxCommittee
from consensus_entropy_tpu.models.committee import FramePool as JaxPool
from consensus_entropy_tpu.serve import FleetServer as JaxServer
from consensus_entropy_tpu.serve import ServeConfig as JaxServeConfig
from consensus_entropy_tpu_torch.al import workspace
from consensus_entropy_tpu_torch.al.loop import ALLoop
from consensus_entropy_tpu_torch.fleet import (
    FleetReport,
    FleetScheduler,
    FleetUser,
)
from consensus_entropy_tpu_torch.obs import export
from consensus_entropy_tpu_torch.obs.trace import Tracer
from consensus_entropy_tpu_torch.resilience import faults
from consensus_entropy_tpu_torch.resilience.faults import FaultRule
from consensus_entropy_tpu_torch.resilience.preemption import Preempted
from consensus_entropy_tpu_torch.serve import (
    AdmissionJournal,
    DispatchBreaker,
    FleetServer,
    PoisonList,
    QueueClosed,
    ServeConfig,
)
from tests.test_torch_fleet import (
    SEED,
    _cfg,
    _committee,
    _data,
    _jax_members,
    _jsonl,
    _raw_user,
    _state,
)

torch.set_num_threads(1)

MODES = ["mc", "hc", "mix", "rand"]


@pytest.fixture(scope="module")
def pools():
    """Users of 20, 30 and 60 songs (buckets 32, 32 and 64) and four more
    for the drills."""
    return {n: _raw_user(300 + n, n) for n in (20, 24, 30, 60, 65, 70)}


def _seq(root, cfg, users, committee_kw=None):
    out = []
    for uid, u in users:
        path = root / f"seq_{uid}"
        path.mkdir()
        out.append(ALLoop(cfg, device="cpu").run_user(
            _committee(u, **(committee_kw or {}).get(uid, {})),
            _data(u, uid), str(path)))
    return out


def _entries(root, users, *, committee_kw=None, factory=True):
    """Serve entries over ``serve_<uid>`` workspaces; a workspace a killed
    run left resumes from its own files, as the CLI's restart does."""
    out = []
    for uid, u in users:
        path = root / f"serve_{uid}"
        path.mkdir(exist_ok=True)
        if (path / "al_state.json").exists():
            committee = workspace.load_committee(str(path))
        else:
            committee = _committee(u, **(committee_kw or {}).get(uid, {}))
        out.append(FleetUser(
            uid, committee, _data(u, uid), str(path), seed=SEED,
            committee_factory=(lambda p=str(path): workspace.load_committee(
                p)) if factory else None))
    return out


def _serve(cfg, entries, serve_cfg=None, *, report=None, journal=None,
           poison=None, preemption=None, on_result=None, **sched_kw):
    sched = FleetScheduler(cfg, report=report or FleetReport(),
                           scoring_by_width=True, device="cpu", **sched_kw)
    server = FleetServer(sched, serve_cfg or ServeConfig(target_live=2),
                         journal=journal, poison=poison,
                         preemption=preemption)
    return server.serve(iter(entries), on_result=on_result), server


def _same(recs, seq):
    for r, s in zip(recs, seq):
        assert r["error"] is None, r
        assert r["result"]["trajectory"] == s["trajectory"]


@pytest.mark.parametrize("mode", MODES)
def test_serve_matches_sequential_and_the_jax_server(pools, tmp_path,
                                                     mode):
    cfg = _cfg(mode, epochs=2)
    users = [("u0", pools[20]), ("u1", pools[30]), ("u2", pools[60])]
    seq = _seq(tmp_path, cfg, users)
    tracer = Tracer(str(tmp_path / "spans.jsonl"), run_id=f"{mode}-{SEED}")
    journal = AdmissionJournal(str(tmp_path / "serve_journal.jsonl"))
    recs, server = _serve(
        cfg, _entries(tmp_path, users),
        ServeConfig(target_live=2, bucket_widths=(32, 64)),
        report=FleetReport(str(tmp_path / "fleet_metrics.jsonl")),
        journal=journal, tracer=tracer)
    journal.close()
    tracer.close()
    _same(recs, seq)
    jax_entries = []
    for uid, u in users:
        x, sids, labels, hc, _, _ = u
        path = tmp_path / f"jax_{uid}"
        path.mkdir()
        jax_entries.append(JaxUser(
            uid, JaxCommittee(copy.deepcopy(_jax_members(u)), []),
            JaxUserData(uid, JaxPool(x, sids), labels, hc_rows=hc),
            str(path), seed=SEED))
    jax_server = JaxServer(
        JaxScheduler(JaxConfig(queries=cfg.queries, epochs=2, mode=mode,
                               seed=SEED, ckpt_dtype="float32"),
                     report=JaxReport(), scoring_by_width=True),
        JaxServeConfig(target_live=2, bucket_widths=(32, 64)))
    jax_recs = jax_server.serve(iter(jax_entries))
    for (uid, _), r, j in zip(users, recs, jax_recs):
        assert j["error"] is None
        assert r["result"]["trajectory"] == j["result"]["trajectory"]
        ours = _jsonl(tmp_path / f"serve_{uid}")
        assert ours == _jsonl(tmp_path / f"seq_{uid}")
        assert _state(tmp_path / f"serve_{uid}") == _state(
            tmp_path / f"seq_{uid}")
        theirs = [e for e in _jsonl(tmp_path / f"jax_{uid}")
                  if "event" not in e]
        for a, b in zip([e for e in ours if "event" not in e], theirs):
            assert a.get("queried") == b.get("queried")
            assert a["f1"] == b["f1"]  # tolerance 0
    # each user padded to its own bucket; the journal shows them finished
    admits = [e for e in server.report.events if e["event"] == "admit"]
    assert [(a["user"], a["width"]) for a in admits] == [
        ("u0", 32), ("u1", 32), ("u2", 64)]
    assert max(a["live"] for a in admits) <= 2
    st = AdmissionJournal(str(tmp_path / "serve_journal.jsonl")).state
    assert st.finished == {"u0", "u1", "u2"}
    assert st.widths == {"u0": 32, "u1": 32, "u2": 64}
    assert export.validate_metrics_file(
        str(tmp_path / "fleet_metrics.jsonl")) == []
    summary = server.report.summary(cohort=2)
    assert summary["admissions"] == 3 and set(summary["per_class"]) == {
        "batch"}
    assert summary["admission_to_finish_s"]["n"] == 3
    spans = export.load_spans([str(tmp_path / "spans.jsonl")])
    assert export.orphan_spans(spans) == []
    names = {s["name"] for s in spans}
    assert {"run", "user", "al_iter", "admission_wait",
            "score_dispatch"} <= names
    assert export.chrome_trace(spans)["traceEvents"]


def test_bucket_parity_across_skewed_pools(pools, tmp_path):
    """Pools of 20, 24, 65 and 70 songs pad to 32 and 80 (not the cohort
    max), dispatch as separate width-tagged groups, and each user's run is
    its sequential one."""
    cfg = _cfg("mc", epochs=2)
    users = [("s0", pools[20]), ("s1", pools[24]), ("b0", pools[70]),
             ("b1", pools[65])]
    seq = _seq(tmp_path, cfg, users)
    # the window phase-aligns the sessions (the engine waits out host work
    # before dispatching a partial round), so same-bucket users stack
    recs, server = _serve(cfg, _entries(tmp_path, users),
                          ServeConfig(target_live=4, bucket_widths=(32, 80)),
                          batch_window_s=5.0)
    _same(recs, seq)
    assert {d.get("width") for d in server.report.dispatches} == {32, 80}
    assert any(d["batch"] > 1 for d in server.report.dispatches)
    assert set(server.report.per_bucket_occupancy) == {32, 80}


def test_eviction_resumes_at_the_admitted_width(pools, tmp_path):
    cfg = _cfg("mc", epochs=2)
    users = [("u0", pools[20]), ("u1", pools[24]), ("u2", pools[30])]
    kw = {"u1": {"victim": True}}
    seq = _seq(tmp_path, cfg, users, committee_kw=kw)
    with faults.inject(FaultRule("member.retrain", "raise", at=1,
                                 member="sgd.victim")) as inj:
        recs, server = _serve(cfg, _entries(tmp_path, users,
                                            committee_kw=kw),
                              ServeConfig(target_live=2,
                                          bucket_widths=(32,)))
    assert inj.fired
    evs = server.report.events
    assert [e["user"] for e in evs if e["event"] == "evict"] == ["u1"]
    assert [e["user"] for e in evs if e["event"] == "resume"] == ["u1"]
    _same(recs, seq)
    assert {d["width"] for d in server.report.dispatches} == {32}


def test_backoff_then_poison_then_skipped(pools, tmp_path):
    """A user whose committee exhausts on every admission is re-queued
    with backoff until its failure budget is spent, then poisoned; the
    user behind it finishes; a restarted server skips the poisoned one."""
    cfg = dataclasses.replace(_cfg("mc", epochs=2), min_members=3)
    users = [("pz", pools[24]), ("w", pools[30])]
    kw = {"pz": {"victim": True}}
    seq = _seq(tmp_path, cfg, users[1:])
    ppath = str(tmp_path / "serve_poison.jsonl")
    with faults.inject(FaultRule("member.retrain", "raise", at=1, times=-1,
                                 member="sgd.victim")):
        recs, server = _serve(
            cfg, _entries(tmp_path, users, committee_kw=kw),
            ServeConfig(target_live=1, failure_budget=2,
                        backoff_base_s=0.01, backoff_max_s=0.02),
            poison=PoisonList(ppath))
    by = {r["user"]: r for r in recs}
    assert by["pz"]["error"] is not None
    _same([by["w"]], seq)
    s = server.report.summary(cohort=1)
    assert s["users_poisoned"] == 1 and s["requeues"] == 1
    assert s["users_failed"] == 1
    evs = [e["event"] for e in server.report.events]
    assert evs.count("admit") == 3  # pz twice (the budget), w once
    recs2, server2 = _serve(cfg, _entries(tmp_path, users[:1],
                                          committee_kw=kw),
                            ServeConfig(target_live=1),
                            poison=PoisonList(ppath))
    assert recs2 == []
    assert any(e["event"] == "skip_poisoned"
               for e in server2.report.events)


def test_breaker_degrades_and_recovers(pools, tmp_path):
    """A failed stacked dispatch opens its bucket's breaker: the group is
    served per user (nobody evicted), then a half-open probe closes it."""
    cfg = _cfg("mc", epochs=2)
    users = [("b0", pools[24]), ("b1", pools[30])]
    seq = _seq(tmp_path, cfg, users)
    breaker = DispatchBreaker(1, 0.0001)
    with faults.inject(FaultRule("serve.dispatch", "transient", at=1)) \
            as inj:
        recs, server = _serve(cfg, _entries(tmp_path, users),
                              breaker=breaker, batch_window_s=5.0)
    assert inj.fired and inj.fired[0]["batch"] == 2
    evs = [e["event"] for e in server.report.events]
    assert "dispatch_failed" in evs and "breaker_open" in evs
    assert "breaker_probe" in evs and "breaker_close" in evs
    assert "evict" not in evs
    _same(recs, seq)
    assert breaker.trips == 1 and breaker.summary() == {}
    s = server.report.summary(cohort=2)
    assert s["breaker_trips"] == 1 and s["dispatch_failures"] == 1


def test_watchdog_evicts_a_hung_host_step(pools, tmp_path):
    cfg = _cfg("mc", epochs=2)
    users = [("h", pools[30])]
    seq = _seq(tmp_path, cfg, users)
    with faults.inject(FaultRule("pool.score", "delay", at=2,
                                 delay_s=1.5)):
        # two host workers: the abandoned, sleeping step cannot starve the
        # resumed session's own host steps
        recs, server = _serve(cfg, _entries(tmp_path, users),
                              ServeConfig(target_live=1, watchdog_s=0.3),
                              host_workers=2)
    evs = [e["event"] for e in server.report.events]
    assert "watchdog_evict" in evs and "resume" in evs
    assert server.scheduler.watchdog.trips >= 1
    _same(recs, seq)
    assert server.report.summary(cohort=1)["watchdog_evictions"] >= 1


def test_drain_finishes_in_flight_and_leaves_the_queue(pools, tmp_path):
    class TripAfter:
        def __init__(self, after):
            self.checks, self.after = 0, after

        @property
        def requested(self):
            self.checks += 1
            return self.checks > self.after

    cfg = _cfg("mc", epochs=2)
    users = [(f"d{i}", pools[n]) for i, n in enumerate((20, 24, 30, 60))]
    seq = dict(zip([u for u, _ in users], _seq(tmp_path, cfg, users)))
    entries = _entries(tmp_path, users)
    with pytest.raises(Preempted, match="drained"):
        _serve(cfg, entries, preemption=TripAfter(1))
    # the in-flight users finished; the queued ones were never touched
    done = {uid for uid, _ in users
            if (tmp_path / f"serve_{uid}" / "al_state.json").exists()}
    assert 1 <= len(done) < len(users)
    for uid in done:
        with open(tmp_path / f"serve_{uid}" / "al_state.json") as f:
            assert json.load(f)["trajectory"] == seq[uid]["trajectory"]
    # a rerun serves the untouched users to their sequential runs
    left = [u for u in users if u[0] not in done]
    recs, server = _serve(cfg, _entries(tmp_path, left))
    _same(recs, [seq[uid] for uid, _ in left])
    assert server.queue.closed
    with pytest.raises(QueueClosed):
        server.queue.put(entries[0])


@pytest.mark.parametrize("kill_at", [4, 9])
def test_kill_at_journal_append_restarts_with_no_user_lost(pools, tmp_path,
                                                           kill_at):
    """Killed at the K-th journal append (mid-cohort), the server is
    restarted from the journal: finished users are skipped, the rest are
    re-admitted in recovery order, and every user ends on its sequential
    run."""
    cfg = _cfg("mc", epochs=2)
    users = [(f"k{i}", pools[n]) for i, n in enumerate((20, 30, 24))]
    seq = dict(zip([u for u, _ in users], _seq(tmp_path, cfg, users)))
    jpath = str(tmp_path / "serve_journal.jsonl")
    done = {}

    def on_result(rec):
        done[rec["user"]] = rec

    journal = AdmissionJournal(jpath)
    with faults.inject(FaultRule("serve.journal.append", "kill",
                                 at=kill_at)) as inj:
        with pytest.raises(faults.InjectedKill):
            _serve(cfg, _entries(tmp_path, users), journal=journal,
                   on_result=on_result)
    assert inj.fired
    journal.close()
    journal = AdmissionJournal(jpath)
    assert journal.recovered
    finished = set(journal.state.finished)
    order = journal.state.recovery_order([u for u, _ in users])
    emap = {e.user_id: e for e in _entries(tmp_path, users)}
    recs, server = _serve(cfg, [emap[u] for u in order], journal=journal,
                          on_result=on_result)
    journal.close()
    assert set(done) == {u for u, _ in users}
    for uid, rec in done.items():
        assert rec["error"] is None
        assert rec["result"]["trajectory"] == seq[uid]["trajectory"]
    skipped = {e["user"] for e in server.report.events
               if e["event"] == "skip_done"}
    assert skipped == finished
    assert bool(finished) == (kill_at == 9)  # 9: after two finishes
    assert AdmissionJournal(jpath).state.finished == set(done)


def test_serve_on_a_two_way_cpu_mesh(pools, tmp_path):
    """``ServeConfig(mesh_devices=2)`` installs a 2-way pool mesh over the
    CPU on the scheduler: every stacked select runs sharded, each user's
    run is its sequential one."""
    cfg = _cfg("mc", epochs=2)
    users = [("m0", pools[20]), ("m1", pools[30])]
    seq = _seq(tmp_path, cfg, users)
    recs, server = _serve(cfg, _entries(tmp_path, users),
                          ServeConfig(target_live=2, bucket_widths=(32,),
                                      mesh_devices=2))
    assert server.scheduler.mesh.size == 2
    _same(recs, seq)
    with pytest.raises(ValueError, match="disagreeing"):
        FleetServer(server.scheduler, ServeConfig(mesh_devices=4))


def test_qbdc_with_narrow_vgg_members_matches_sequential_and_jax(tmp_path):
    """One qbdc case: GaussianNB + SGD + 2 vgg members at the tiny CNN
    geometry of the CNN tests; each user's run is its sequential one and
    its queried songs equal the JAX server's (host F1s tolerance 0, CNN
    F1s within 1e-6, as the sequential loops are held)."""
    import numpy as np

    from consensus_entropy_tpu.config import ALConfig as JaxALConfig
    from consensus_entropy_tpu.data.audio import DeviceWaveformStore
    from consensus_entropy_tpu.models.committee import CNNMember as JaxCNN
    from consensus_entropy_tpu_torch.config import ALConfig
    from tests import test_torch_cnn_fleet as cf

    cfg = ALConfig(queries=cf.Q, epochs=1, mode="qbdc", seed=cf.SEED,
                   qbdc_k=cf.QBDC_K, ckpt_dtype="float32")
    users = [cf._user(1987 + i) for i in range(2)]
    seq, entries, jax_entries = [], [], []
    for i, u in enumerate(users):
        for kind in ("seq", "serve", "jax"):
            (tmp_path / f"{kind}_q{i}").mkdir()
        seq.append(ALLoop(cfg, retrain_epochs=cf.RETRAIN,
                          device="cpu").run_user(
            cf._committee(u), cf._data(u, f"q{i}"),
            str(tmp_path / f"seq_q{i}")))
        entries.append(FleetUser(f"q{i}", cf._committee(u),
                                 cf._data(u, f"q{i}"),
                                 str(tmp_path / f"serve_q{i}"), seed=cf.SEED))
        x, sids, labels, waves, host, cnn_vars = u
        jax_entries.append(JaxUser(
            f"q{i}", JaxCommittee(
                copy.deepcopy(host),
                [JaxCNN(f"cnn.it_{j}", v, cf.JAX_TINY, cf.JAX_TC)
                 for j, v in enumerate(cnn_vars)], cf.JAX_TINY, cf.JAX_TC),
            JaxUserData(f"q{i}", JaxPool(x, sids), labels,
                        store=DeviceWaveformStore(waves,
                                                  cf.TINY.input_length)),
            str(tmp_path / f"jax_q{i}"), seed=cf.SEED))
    recs, server = _serve(cfg, entries, ServeConfig(target_live=2),
                          retrain_epochs=cf.RETRAIN)
    _same(recs, seq)
    assert "qbdc_probs" in server.report.summary(cohort=2)["cnn"]
    jax_server = JaxServer(
        JaxScheduler(JaxALConfig(queries=cf.Q, epochs=1, mode="qbdc",
                                 seed=cf.SEED, qbdc_k=cf.QBDC_K,
                                 ckpt_dtype="float32"),
                     retrain_epochs=cf.RETRAIN, report=JaxReport(),
                     scoring_by_width=True),
        JaxServeConfig(target_live=2))
    for j in jax_server.serve(iter(jax_entries)):
        assert j["error"] is None
    for i in range(2):
        ours = [e for e in _jsonl(tmp_path / f"serve_q{i}")
                if "event" not in e]
        assert ours == [e for e in _jsonl(tmp_path / f"seq_q{i}")
                        if "event" not in e]
        theirs = [e for e in _jsonl(tmp_path / f"jax_q{i}")
                  if "event" not in e]
        assert len(ours) == len(theirs) == 2
        for a, b in zip(ours, theirs):
            assert a.get("queried") == b.get("queried")
            assert a["f1"][2:] == b["f1"][2:]
            np.testing.assert_allclose(a["f1"][:2], b["f1"][:2], atol=1e-6)
