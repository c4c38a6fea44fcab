"""The port's workload package against the JAX package's, on the CPU.

``generate`` and ``save`` write the bytes the JAX package writes for the
same spec (poisson, mmpp and replay arrivals; bucket, skew and cycle
pools; churn; a horizon), with the same ``trace_digest``, and each
package loads the other's file; ``validate_records`` returns the JAX
package's errors; ``TraceDriver`` plays a seeded trace compressed into
the port's ``FleetServer`` (every user on its sequential run) and its
backoff on ``QueueFull`` replays from its seed; ``grade_run`` is
deterministic, reads a torn stream tail and flags a lost user, equal to
the JAX grader on the same artifacts.  Tolerance: none, every comparison
is exact."""

import json
import os

import pytest
import torch

from consensus_entropy_tpu.workload import grade as jax_grade
from consensus_entropy_tpu.workload import trace as jax_trace
from consensus_entropy_tpu_torch.al import workspace
from consensus_entropy_tpu_torch.al.loop import ALLoop
from consensus_entropy_tpu_torch.fleet import (
    FleetReport,
    FleetScheduler,
    FleetUser,
)
from consensus_entropy_tpu_torch.serve import (
    AdmissionJournal,
    FleetServer,
    QueueClosed,
    QueueFull,
    ServeConfig,
)
from consensus_entropy_tpu_torch.workload import (
    DriverStats,
    ServerTarget,
    TraceDriver,
    TraceSpec,
    deterministic_equal,
    generate,
    grade_run,
    load,
    percentile,
    save,
    spec_from_meta,
    trace_digest,
    validate_records,
)
from tests.test_torch_fleet import SEED, _cfg, _committee, _data, _raw_user

torch.set_num_threads(1)

SPECS = [
    dict(seed=3, n_users=12),
    dict(seed=4, n_users=20, arrival="mmpp", rate=2.0, burst_dwell_s=0.5,
         pool_dist="skew", churn_frac=0.25, horizon_s=3.0),
    dict(seed=5, n_users=4, arrival="replay",
         timestamps=(0.0, 0.25, 0.25, 1.5), pool_dist="cycle",
         pool_sizes=(20, 30), class_mix=(("interactive", 0.2),
                                         ("batch", 0.8))),
    dict(seed=6, n_users=9, rate=20.0, churn_frac=1.0, churn_delay_s=0.1,
         reconnect_s=0.05),
]


@pytest.mark.parametrize("kw", SPECS, ids=["poisson", "mmpp-skew-churn",
                                           "replay-cycle", "churn-all"])
def test_traces_are_the_jax_packages_bytes(tmp_path, kw):
    ours = generate(TraceSpec(**kw))
    theirs = jax_trace.generate(jax_trace.TraceSpec(**kw))
    assert ours.meta == theirs.meta and ours.events == theirs.events
    assert trace_digest(ours) == jax_trace.trace_digest(theirs)
    a, b = str(tmp_path / "ours.jsonl"), str(tmp_path / "theirs.jsonl")
    save(ours, a)
    jax_trace.save(theirs, b)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    back = load(b)
    assert trace_digest(back) == trace_digest(ours)
    assert trace_digest(generate(spec_from_meta(back.meta))) == \
        trace_digest(ours)
    assert jax_trace.trace_digest(jax_trace.load(a)) == trace_digest(ours)
    assert back.users == theirs.users
    assert trace_digest(generate(TraceSpec(**{**kw, "seed": 99}))) != \
        trace_digest(ours)


@pytest.mark.parametrize("bad", [
    dict(n_users=0), dict(arrival="nope"), dict(arrival="replay",
                                                timestamps=(1.0,)),
    dict(rate=0.0), dict(arrival="mmpp", burst_dwell_s=0),
    dict(class_mix=()), dict(pool_dist="x"), dict(pool_sizes=(0,)),
    dict(churn_frac=2.0), dict(reconnect_s=0), dict(horizon_s=-1.0)])
def test_spec_validation_equals_jax(bad):
    with pytest.raises(ValueError) as ours:
        TraceSpec(**bad)
    with pytest.raises(ValueError) as theirs:
        jax_trace.TraceSpec(**bad)
    assert str(ours.value) == str(theirs.value)


def test_record_validation_equals_jax(tmp_path):
    head = {"schema": 1, "kind": "trace_header"}
    cases = [
        [],
        [{"kind": "arrive"}],
        [dict(head, schema=2)],
        [head, "x", {"kind": "jump", "t": 0, "user": "u"},
         {"kind": "arrive", "t": -1, "user": "u"},
         {"kind": "arrive", "t": 1, "user": ""},
         {"kind": "arrive", "t": 2, "user": "u0", "cls": 3, "pool": 0},
         {"kind": "arrive", "t": 1.5, "user": "u0", "cls": "b",
          "pool": True},
         {"kind": "disconnect", "t": 3, "user": "u9"},
         {"kind": "disconnect", "t": 3, "user": "u0"},
         {"kind": "disconnect", "t": 3, "user": "u0"},
         {"kind": "reconnect", "t": 4, "user": "u1"}],
    ]
    for recs in cases:
        errs = validate_records(recs)
        assert errs and errs == jax_trace.validate_records(recs)
    path = str(tmp_path / "bad.jsonl")
    with open(path, "w") as f:
        for r in cases[-1]:
            f.write(json.dumps(r) + "\n")
    with pytest.raises(ValueError, match="invalid trace"):
        load(path)


class _FakeTime:
    def __init__(self):
        self.t = 0.0

    def clock(self):
        return self.t

    def sleep(self, s):
        self.t += max(float(s), 0.0)


class _Probe:
    """A target that refuses per user first, then records each call at
    its virtual time."""

    def __init__(self, ft, refuse=None):
        self.ft, self.refuse, self.calls = ft, dict(refuse or {}), []
        self.closed = False

    def submit(self, uid, *, cls, pool):
        left = self.refuse.get(uid)
        if left:
            self.refuse[uid] = left[1:]
            raise left[0]
        self.calls.append((round(self.ft.t, 6), "submit", uid))

    def disconnect(self, uid):
        self.calls.append((round(self.ft.t, 6), "disconnect", uid))

    def close(self):
        self.closed = True


def test_driver_schedule_backoff_and_refusals():
    t = generate(TraceSpec(seed=3, n_users=4, arrival="replay",
                           timestamps=(0.0, 10.0, 20.0, 40.0),
                           pool_dist="cycle", pool_sizes=(8,)))
    ft = _FakeTime()
    probe = _Probe(ft)
    stats = TraceDriver(t, probe, time_scale=0.1, clock=ft.clock,
                        sleep=ft.sleep).run()
    assert [(c[0], c[2]) for c in probe.calls] == [
        (0.0, "u0"), (1.0, "u1"), (2.0, "u2"), (4.0, "u3")]
    assert stats.submitted == 4 and probe.closed
    slept = []
    for _ in range(2):  # the same seed backs off on the same schedule
        ft = _FakeTime()
        probe = _Probe(ft, refuse={"u0": [QueueFull("x")] * 3})
        st = TraceDriver(t, probe, clock=ft.clock, sleep=ft.sleep,
                         backoff_seed=7, time_scale=1e-3).run()
        assert st.queue_full_retries == 3 and st.submitted == 4
        slept.append(ft.t)
    assert slept[0] == slept[1] > 0
    churn = generate(TraceSpec(seed=5, n_users=4, churn_frac=1.0))
    ft = _FakeTime()
    victim = churn.users[0]
    probe = _Probe(ft, refuse={victim: [QueueClosed("closed")]})
    st = TraceDriver(churn, probe, time_scale=0.01, clock=ft.clock,
                     sleep=ft.sleep).run()
    assert st.rejected == 1 and st.skipped == 2
    assert st.disconnects == 3 and st.reconnects == 3
    assert set(DriverStats().as_dict()) == set(st.as_dict())


def test_trace_played_into_the_fleet_server(tmp_path):
    """A seeded 3-user trace (two classes, pools over two buckets) played
    compressed by ``TraceDriver(ServerTarget)`` into a live server with
    its journal: every user finishes on its sequential run, the grader
    finds no loss and a clean stream."""
    cfg = _cfg("mc", epochs=2)
    raw = {20: _raw_user(320, 20), 60: _raw_user(360, 60)}
    t = generate(TraceSpec(seed=9, n_users=3, arrival="replay",
                           timestamps=(0.0, 0.1, 0.2), pool_dist="cycle",
                           pool_sizes=(20, 60, 20)))
    seq = {}
    for ev in t.events:
        uid, u = ev["user"], raw[ev["pool"]]
        path = tmp_path / f"seq_{uid}"
        path.mkdir()
        seq[uid] = ALLoop(cfg, device="cpu").run_user(
            _committee(u), _data(u, uid), str(path))
    users_dir = tmp_path / "users"
    users_dir.mkdir()

    def build_entry(uid, cls, pool):
        path = tmp_path / f"serve_{uid}"
        path.mkdir()
        u = raw[pool]
        return FleetUser(uid, _committee(u), _data(u, uid), str(path),
                         seed=SEED, committee_factory=lambda p=str(path):
                         workspace.load_committee(p))

    jpath = str(users_dir / "serve_journal.jsonl")
    journal = AdmissionJournal(jpath)
    sched = FleetScheduler(cfg, report=FleetReport(str(
        users_dir / "fleet_metrics.jsonl")), scoring_by_width=True,
        device="cpu")
    server = FleetServer(sched, ServeConfig(target_live=2),
                         journal=journal)
    driver = TraceDriver(t, ServerTarget(server, build_entry),
                         time_scale=0.05).start()
    done = {}
    try:
        server.serve((), on_result=lambda r: done.update({r["user"]: r}),
                     keep_open=True)
    finally:
        assert driver.join(timeout=60.0)
        journal.close()
        sched.report.close()
    assert driver.stats.submitted == 3 and driver.stats.rejected == 0
    for uid in t.users:
        assert done[uid]["error"] is None
        assert done[uid]["result"]["trajectory"] == seq[uid]["trajectory"]
    g = grade_run(str(users_dir), journal_path=jpath, trace=t,
                  slo_s={"interactive": 60.0, "batch": 600.0}, wall_s=1.0,
                  driver_stats=driver.stats.as_dict())
    assert g["deterministic"]["zero_loss"]
    assert g["deterministic"]["stream_ok"] and g["deterministic"][
        "journal_ok"]
    assert g["deterministic"]["trace_sha"] == trace_digest(t)
    assert sum(r["n"] for r in g["measured"]["per_class"].values()) == 3
    # a queued user can be withdrawn; an in-flight one cannot be here
    target = ServerTarget(server, build_entry)
    with pytest.raises(RuntimeError, match="not queued"):
        target.disconnect("u0")


def _grade_fixture(tmp_path, *, lose_u1=False):
    """A finished two-user run: its trace, journal and metrics stream with
    a torn tail."""
    t = generate(TraceSpec(seed=2, n_users=2, arrival="replay",
                           timestamps=(0.0, 0.1),
                           class_mix=(("interactive", 1.0),),
                           pool_sizes=(8,)))
    users_dir = str(tmp_path / "users")
    os.makedirs(users_dir, exist_ok=True)
    jp = os.path.join(users_dir, "serve_journal.jsonl")
    j = AdmissionJournal(jp)
    for u in t.users:
        j.append("enqueue", u, cls="interactive")
        j.append("admit", u, width=8)
    j.append("finish", t.users[0])
    if not lose_u1:
        j.append("finish", t.users[1])
    j.close()
    report = FleetReport(os.path.join(users_dir, "fleet_metrics.jsonl"))
    for u in t.users:
        report.event("enqueue", user=u, depth=1)
    report.event("user_done", user=t.users[0])
    if not lose_u1:
        report.event("user_done", user=t.users[1])
    report.close()
    with open(os.path.join(users_dir, "fleet_metrics.jsonl"), "ab") as f:
        f.write(b'{"event": "user_do')  # a kill's torn tail
    return t, users_dir, jp


def test_grader_is_deterministic_and_flags_lost_users(tmp_path):
    t, users_dir, jp = _grade_fixture(tmp_path / "a")
    g = grade_run(users_dir, journal_path=jp, trace=t,
                  slo_s={"interactive": 60.0}, wall_s=2.0,
                  driver_stats={"submitted": 2})
    theirs = jax_grade.grade_run(users_dir, journal_path=jp, trace=t,
                                 slo_s={"interactive": 60.0}, wall_s=2.0,
                                 driver_stats={"submitted": 2})
    assert g["deterministic"] == theirs["deterministic"]
    assert g["deterministic"]["zero_loss"] and g["deterministic"][
        "finished"] == 2
    assert g["measured"]["per_class"]["interactive"]["within_slo"]
    g2 = grade_run(users_dir, journal_path=jp, trace=t, wall_s=9.9)
    assert deterministic_equal(g, g2)
    assert deterministic_equal(json.loads(json.dumps(g)), g2)
    t, lost_dir, lost_jp = _grade_fixture(tmp_path / "b", lose_u1=True)
    lost = grade_run(lost_dir, journal_path=lost_jp, trace=t)
    assert lost["deterministic"]["lost_users"] == [t.users[1]]
    assert not lost["deterministic"]["zero_loss"]
    assert not deterministic_equal(g, lost)
    for q in (0, 50, 95, 99):
        xs = [3.0, 1.0, 2.0, 10.0]
        assert percentile(xs, q) == jax_grade.percentile(xs, q)
    assert percentile([], 50) is None
