"""The port's fabric seams and a 2-host kill drill against the JAX
package, on the CPU.

``JsonlTail`` on a torn tail with a rotten line reads what JAX's reads
and quarantines the same bytes; ``HostLease`` beats and ``EpochGate``
latches as JAX's do; the scheduler's release hooks release a session at
its checkpoint (or any step) with the generation JAX's report, and the
released workspace resumes to the sequential run; ``FleetServer.fence``,
``evict`` and ``apply_fleet_edges`` journal the acks and edges JAX's
journal; the ``stall`` and ``slow`` actions parse, refuse and hold as
JAX's.  Then one drill: 3 users over 2 worker processes
(``tests/torch_fabric_worker.py``), the first worker SIGKILLed at its
first admission; every user's result equals its sequential port run,
which equals the JAX sequential run; the port's journal replays in JAX's
``AdmissionJournal`` to an equal state, and both validators find
nothing.  Tolerance 0 throughout."""

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from consensus_entropy_tpu.config import ALConfig as JaxConfig
from consensus_entropy_tpu.fleet import FleetReport as JaxReport
from consensus_entropy_tpu.fleet import FleetScheduler as JaxScheduler
from consensus_entropy_tpu.fleet import FleetUser as JaxUser
from consensus_entropy_tpu.al.loop import UserData as JaxUserData
from consensus_entropy_tpu.models.committee import Committee as JaxCommittee
from consensus_entropy_tpu.models.committee import FramePool as JaxPool
from consensus_entropy_tpu.resilience import faults as jax_faults
from consensus_entropy_tpu.serve import FleetServer as JaxServer
from consensus_entropy_tpu.serve import ServeConfig as JaxServeConfig
from consensus_entropy_tpu.serve import hosts as jax_hosts
from consensus_entropy_tpu.serve import journal as jax_journal
from consensus_entropy_tpu_torch.al import workspace
from consensus_entropy_tpu_torch.al.loop import ALLoop
from consensus_entropy_tpu_torch.fleet import (
    FleetReport,
    FleetScheduler,
    FleetUser,
)
from consensus_entropy_tpu_torch.resilience import faults
from consensus_entropy_tpu_torch.resilience.faults import (
    FaultRule,
    InjectedKill,
)
from consensus_entropy_tpu_torch.serve import (
    AdmissionJournal,
    FabricConfig,
    FabricCoordinator,
    FleetServer,
    JsonlTail,
    ServeConfig,
    validate_journal_file,
)
from consensus_entropy_tpu_torch.serve import hosts
from tests import fabric_workload as jax_workload
from tests import torch_fabric_workload as workload
from tests.test_torch_fleet import (
    SEED,
    _cfg,
    _committee,
    _data,
    _jax_members,
    _raw_user,
    _state,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_fabric_worker.py")


# -- JsonlTail, HostLease, EpochGate --------------------------------------


def test_jsonl_tail_torn_tail_and_rot_match_jax(tmp_path):
    """A framed WAL (written by the port's journal) with a legacy line, a
    complete line whose CRC fails and a torn last line: both tails return
    the same records and offsets, count one corrupt line, quarantine the
    same bytes, and pick the torn line up once it completes."""
    src = str(tmp_path / "events.jsonl")
    with AdmissionJournal(src) as j:
        j.append("admit", "u0")
        j.append("finish", "u0")
    with open(src, "ab") as f:
        f.write(b'{"event": "admit", "user": "u1"}\n')
        f.write(b'w1 00000000 {"event": "finish", "user": "u1"}\n')
        f.write(b'w1 12345678 {"event": "adm')
    out = {}
    for pkg, cls in (("port", JsonlTail), ("jax", jax_journal.JsonlTail)):
        path = str(tmp_path / f"{pkg}.jsonl")
        with open(src, "rb") as f, open(path, "wb") as g:
            g.write(f.read())
        t = cls(path)
        first = t.poll()
        again = t.poll()
        from consensus_entropy_tpu_torch.resilience import io as dio

        rec = {"event": "admit", "user": "u2"}
        with open(path, "rb") as f:
            body = f.read()
        with open(path, "wb") as f:  # the writer finishes the torn line
            f.write(body[:body.rindex(b"\n") + 1] + dio.frame_record(rec))
        done = t.poll()
        t2 = cls(path)
        t2.seek(first[-1][1])
        resumed = t2.poll()
        with open(path + ".quarantine", "rb") as f:
            sidecar = f.read()
        out[pkg] = ([(r, o) for r, o in first], again, done, resumed,
                    t.corrupt, sidecar)
        t.close()
        t2.close()
    assert out["port"] == out["jax"]
    assert [r["user"] for r, _ in out["port"][0]] == ["u0", "u0", "u1"]
    assert out["port"][4] == 1


def test_host_lease_and_epoch_gate_match_jax(tmp_path):
    beats = {}
    for pkg, mod in (("port", hosts), ("jax", jax_hosts)):
        lp = str(tmp_path / f"{pkg}.json")
        lease = mod.HostLease(lp, "h3", 0.1, devices=4,
                              step_source=lambda: 0.123456)
        lease.beat_once()
        lease.beat_once()
        rec = mod.read_lease(lp)
        assert 0 <= mod.lease_age_s(lp) < 5.0
        assert mod.lease_age_s(lp, now=rec["t"] + 2.5) == 2.5
        beats[pkg] = {k: v for k, v in rec.items() if k != "t"}
        assert mod.read_lease(str(tmp_path / "missing.json")) is None
        with pytest.raises(ValueError) as e:
            mod.HostLease(lp, "h0", 0)
        beats[pkg + "_err"] = str(e.value)
    assert beats["port"] == beats["jax"]
    assert beats["port"]["devices"] == 4 and beats["port"]["beat"] == 2
    assert beats["port_err"] == beats["jax_err"]
    # the read sides read each other's files
    assert hosts.read_lease(str(tmp_path / "jax.json"))["host"] == "h3"
    assert hosts.fabric_paths("/f", "h2") == jax_hosts.fabric_paths(
        "/f", "h2")
    # the fault point fires before the write: the old beat stays
    lp = str(tmp_path / "port.json")
    lease = hosts.HostLease(lp, "h3", 0.1)
    with faults.inject(FaultRule("fabric.lease", "kill", at=1)):
        with pytest.raises(InjectedKill):
            lease.beat_once()
    assert hosts.read_lease(lp)["beat"] == 2
    lines = [{"user": "a"}, {"user": "b", "ep": 2}, {"drop": "a", "ep": 1},
             {"fence": "b", "ep": 2}, {"ep": 3, "user": "c"},
             {"user": "d", "ep": 2}, {"close": True}]
    gates = [hosts.EpochGate(), jax_hosts.EpochGate()]
    seen = [[(g.admit(r), g.epoch, g.fenced) for r in lines] for g in gates]
    assert seen[0] == seen[1]
    assert [s[0] for s in seen[0]] == [True, True, False, True, True,
                                       False, True]
    assert hosts.EXIT_ORPHANED == jax_hosts.EXIT_ORPHANED == 76


# -- the scheduler's release hooks -----------------------------------------


@pytest.fixture(scope="module")
def users():
    return [("u0", _raw_user(500, 26)), ("u1", _raw_user(501, 30))]


def _jax_entry(root, uid, u):
    x, sids, labels, hc, _, _ = u
    path = root / f"jax_{uid}"
    path.mkdir(exist_ok=True)
    return JaxUser(uid, JaxCommittee(copy.deepcopy(_jax_members(u)), []),
                   JaxUserData(uid, JaxPool(x, sids), labels, hc_rows=hc),
                   str(path), seed=SEED)


def _port_entry(root, uid, u):
    path = root / f"port_{uid}"
    path.mkdir(exist_ok=True)
    committee = (workspace.load_committee(str(path))
                 if (path / "al_state.json").exists() else _committee(u))
    return FleetUser(uid, committee, _data(u, uid), str(path), seed=SEED,
                     committee_factory=lambda p=str(path):
                     workspace.load_committee(p))


def _jax_cfg(epochs):
    return JaxConfig(queries=4, epochs=epochs, mode="mc", seed=SEED,
                     ckpt_dtype="float32")


def _released_run(sched, entries, verb, uid):
    sched.open(len(entries))
    try:
        for e in entries:
            sched.admit(e, pad=32)
        verdicts = [getattr(sched, verb)(uid), getattr(sched, verb)("nope")]
        while sched.pump():
            pass
        released = sched.take_released()
        again = sched.take_released()
    finally:
        sched.close()
    done = {str(r["user"]): r["result"]["trajectory"]
            for r in sched.results.values() if r["error"] is None}
    kinds = [e["event"] for e in sched.report.events
             if e["event"] in ("fence_release", "user_done")]
    return verdicts, released, again, done, kinds


@pytest.mark.parametrize("verb", ["request_release", "force_release"])
def test_release_hooks_match_jax_and_resume(tmp_path, users, verb):
    """Marked at admission, u0 releases at its first checkpoint boundary
    (``request_release``: generation 0, the baseline's commit) or its first
    step (``force_release``: no generation); u1 runs on.  Both engines
    report the same verdicts, releases and events; u0's released
    workspace resumes in a fresh engine to its sequential run."""
    cfg = _cfg("mc", epochs=2)
    ours = _released_run(
        FleetScheduler(cfg, report=FleetReport(), device="cpu"),
        [_port_entry(tmp_path, uid, u) for uid, u in users], verb, "u0")
    theirs = _released_run(
        JaxScheduler(_jax_cfg(2), report=JaxReport()),
        [_jax_entry(tmp_path, uid, u) for uid, u in users], verb, "u0")
    assert ours == theirs
    verdicts, released, again, done, _ = ours
    assert verdicts == [True, False] and again == {}
    assert released == {"u0": 0 if verb == "request_release" else None}
    assert set(done) == {"u1"}
    if verb == "request_release":
        assert _state(tmp_path / "port_u0")["next_epoch"] == 0
        assert _state(tmp_path / "port_u0") == _state(tmp_path / "jax_u0")
    seq = tmp_path / "seq_u0"
    seq.mkdir()
    ref = ALLoop(cfg, device="cpu").run_user(
        _committee(users[0][1]), _data(users[0][1], "u0"), str(seq))
    sched = FleetScheduler(cfg, report=FleetReport(), device="cpu")
    (rec,) = sched.run([_port_entry(tmp_path, "u0", users[0][1])])
    assert rec["result"]["trajectory"] == ref["trajectory"]
    assert _state(tmp_path / "port_u0") == _state(seq)


# -- the server's fence, evict and fleet-edge seams ------------------------


def _served(server, sched, entries, on_first_pump):
    """Submit every entry, serve, and call ``on_first_pump(server)`` at
    the engine's first round (the first users admitted, the rest queued)."""
    pump, calls = sched.pump, []

    def first_pump():
        if not calls:
            calls.append(on_first_pump(server))
        return pump()

    sched.pump = first_pump
    for e in entries:
        server.submit(e)
    server.close_intake()
    server.serve(())
    return calls


@pytest.mark.parametrize("verb", ["fence", "evict"])
def test_fence_and_evict_journal_the_jax_acks(tmp_path, users, verb):
    """One slot, two users: at the first engine round u0 is in flight and
    u1 queued.  ``fence``/``evict`` of u1 withdraws it at once (True); of
    u0 defers (None) and the serve loop journals the ack when the engine
    releases u0 (a ``fence`` with the checkpoint generation, or a
    ``drop``); of an unknown user refuses (False).  Both servers journal
    the same acks."""
    cfg = _cfg("mc", epochs=2)
    out = {}
    for pkg in ("port", "jax"):
        jp = str(tmp_path / f"{pkg}_journal.jsonl")
        if pkg == "port":
            journal = AdmissionJournal(jp)
            sched = FleetScheduler(cfg, report=FleetReport(),
                                   scoring_by_width=True, device="cpu")
            server = FleetServer(sched, ServeConfig(target_live=1),
                                 journal=journal)
            entries = [_port_entry(tmp_path, uid, u) for uid, u in users]
        else:
            journal = jax_journal.AdmissionJournal(jp)
            sched = JaxScheduler(_jax_cfg(2), report=JaxReport(),
                                 scoring_by_width=True)
            server = JaxServer(sched, JaxServeConfig(target_live=1),
                               journal=journal)
            entries = [_jax_entry(tmp_path, uid, u) for uid, u in users]
        calls = _served(server, sched, entries, lambda s: [
            getattr(s, verb)("u1"), getattr(s, verb)("u0"),
            getattr(s, verb)("zz")])
        journal.close()
        records = [
            (r["event"], r.get("user"), r.get("ok"), r.get("gen"))
            for r in _read(jp) if r["event"] in ("fence", "drop", "finish",
                                                 "admit")]
        out[pkg] = (calls, records, [str(r["user"]) for r in
                                     server.results])
        assert validate_journal_file(jp) == []
        assert jax_journal.validate_journal_file(jp) == []
    assert out["port"] == out["jax"]
    calls, records, _ = out["port"]
    assert calls == [[True, None, False]]
    kind = "fence" if verb == "fence" else "drop"
    ack = [r for r in records if r[0] == kind]
    assert ack and ack[-1][1] == "u0" and ack[-1][2] is True
    if verb == "fence":
        assert isinstance(ack[-1][3], int)


class _Status:
    def __init__(self):
        self.payloads = []

    def maybe_write(self, payload_fn):
        self.payloads.append(payload_fn())


def test_status_limb_payloads_match_jax(tmp_path, users):
    """A status writer given to either server is asked for the same
    payloads (the JAX payload's ``jit`` section aside: the port compiles
    nothing at run time; the port's ``alert_sink_errors``, 0, aside); the
    alert watcher beside it evaluates the same
    alerts.  Timing fields (the planner's host-step EMA, bucket
    occupancy) are set aside."""
    from consensus_entropy_tpu.obs.alerts import AlertWatcher as JaxWatcher
    from consensus_entropy_tpu_torch.obs.alerts import AlertWatcher

    cfg = _cfg("mc", epochs=1)
    out = {}
    for pkg in ("port", "jax"):
        status = _Status()
        if pkg == "port":
            sched = FleetScheduler(cfg, report=FleetReport(),
                                   scoring_by_width=True, device="cpu")
            server = FleetServer(sched, ServeConfig(target_live=1),
                                 status=status,
                                 alerts=AlertWatcher(sched.report))
            entries = [_port_entry(tmp_path, uid, u) for uid, u in users]
        else:
            sched = JaxScheduler(_jax_cfg(1), report=JaxReport(),
                                 scoring_by_width=True)
            server = JaxServer(sched, JaxServeConfig(target_live=1),
                               status=status,
                               alerts=JaxWatcher(sched.report))
            entries = [_jax_entry(tmp_path, uid, u) for uid, u in users]
        for e in entries:
            server.submit(e)
        server.close_intake()
        server.serve(())
        for p in status.payloads:
            p.pop("jit", None)
            p.pop("buckets", None)
            # the port's count of alert-sink failures (no sink here)
            assert p.pop("alert_sink_errors", 0) == 0
            for k in ("host_step_ema_s", "admission_hold_rounds",
                      "dispatch_hold_rounds"):
                p.get("planner", {}).pop(k, None)
        out[pkg] = (status.payloads[0], status.payloads[-1],
                    sorted({k for p in status.payloads for k in p}))
    assert out["port"] == out["jax"]
    first, last, _ = out["port"]
    assert first["queue_total"] == 2 and last["users_done"] >= 1


def _read(path):
    with open(path, "rb") as f:
        recs = [jax_journal.dio.parse_frame(line)[1] for line in f]
    return [r for r in recs if isinstance(r, dict) and "event" in r]


def test_server_target_disconnects_an_in_flight_user(tmp_path, users):
    """``ServerTarget.disconnect`` of the user in flight evicts it (a
    deferred ``drop`` ack at its next step), of the queued one withdraws
    it; the JAX target journals the same."""
    from consensus_entropy_tpu.workload import ServerTarget as JaxTarget
    from consensus_entropy_tpu_torch.workload import ServerTarget

    cfg = _cfg("mc", epochs=2)
    out = {}
    for pkg in ("port", "jax"):
        jp = str(tmp_path / f"{pkg}_journal.jsonl")
        if pkg == "port":
            journal = AdmissionJournal(jp)
            sched = FleetScheduler(cfg, report=FleetReport(),
                                   scoring_by_width=True, device="cpu")
            server = FleetServer(sched, ServeConfig(target_live=1),
                                 journal=journal)
            entries = [_port_entry(tmp_path, uid, u) for uid, u in users]
            target = ServerTarget(server, None)
        else:
            journal = jax_journal.AdmissionJournal(jp)
            sched = JaxScheduler(_jax_cfg(2), report=JaxReport(),
                                 scoring_by_width=True)
            server = JaxServer(sched, JaxServeConfig(target_live=1),
                               journal=journal)
            entries = [_jax_entry(tmp_path, uid, u) for uid, u in users]
            target = JaxTarget(server, None)
        _served(server, sched, entries, lambda s: [
            target.disconnect("u1"), target.disconnect("u0")])
        journal.close()
        out[pkg] = ([(r["event"], r.get("user"), r.get("ok"))
                     for r in _read(jp)], len(server.results))
    assert out["port"] == out["jax"]
    records, n_results = out["port"]
    assert ("drop", "u0", True) in records and n_results == 0
    assert not any(e == "finish" for e, _, _ in records)


def test_apply_fleet_edges_matches_jax(tmp_path, users):
    """The coordinator's edges before any admission: the planner stops
    deriving its own, the router pads by them, the planner journals one
    ``fleet`` record and the report an event, in both servers; without a
    planner the router alone adopts them."""
    cfg = _cfg("mc", epochs=1)
    out = {}
    for pkg in ("port", "jax"):
        jp = str(tmp_path / f"{pkg}.jsonl")
        if pkg == "port":
            journal = AdmissionJournal(jp)
            sched = FleetScheduler(cfg, report=FleetReport(),
                                   scoring_by_width=True, device="cpu")
            server = FleetServer(sched, ServeConfig(target_live=2),
                                 journal=journal)
            entries = [_port_entry(tmp_path, uid, u) for uid, u in users]
        else:
            journal = jax_journal.AdmissionJournal(jp)
            sched = JaxScheduler(_jax_cfg(1), report=JaxReport(),
                                 scoring_by_width=True)
            server = JaxServer(sched, JaxServeConfig(target_live=2),
                               journal=journal)
            entries = [_jax_entry(tmp_path, uid, u) for uid, u in users]
        server.apply_fleet_edges([48, 96])
        server.apply_fleet_edges([])  # empty broadcast: ignored
        server.serve(iter(entries))
        journal.close()
        planner = [(r["edges"], r.get("fleet")) for r in _read(jp)
                   if r["event"] == "planner"]
        widths = [(e["user"], e["width"]) for e in sched.report.events
                  if e["event"] == "admit"]
        fleet_ev = [e["edges"] for e in sched.report.events
                    if e["event"] == "fleet_edges"]
        # the hold counters and the host-step EMA follow host timing
        summary = {k: v for k, v in server.planner.summary().items()
                   if k in ("edges", "edge_updates", "observations",
                            "slo_s", "fleet_edges")}
        out[pkg] = (planner, widths, fleet_ev, summary,
                    [server.router.width_for(n) for n in (10, 60, 97)])
        bare = (FleetServer if pkg == "port" else JaxServer)(
            FleetScheduler(cfg, report=FleetReport(),
                           scoring_by_width=True, device="cpu")
            if pkg == "port" else
            JaxScheduler(_jax_cfg(1), report=JaxReport(),
                         scoring_by_width=True),
            (ServeConfig if pkg == "port" else JaxServeConfig)(
                target_live=2, slo_planner=False))
        bare.apply_fleet_edges((64,))
        out[pkg] += ([bare.router.width_for(n) for n in (10, 60, 97)],)
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == ([48, 96], True)
    assert out["port"][3]["fleet_edges"] is True
    assert out["port"][1] == [("u0", 48), ("u1", 48)]


# -- the gray actions -------------------------------------------------------


SPECS = ["serve.dispatch:stall=2.5@1x-1", "serve.feed.poll:slow=3",
         "io.fsync:stall=inf", "io.fsync:stall", "io.fsync:slow",
         "fabric.gray:kill@2,fabric.remedy:delay=0.5x3"]
BAD = ["io.fsync:kill=3", "io.fsync:stall=abc", "io.fsync:slow=0.5",
       "io.fsync:stall=-1", "fabric.nope:kill"]


def test_stall_and_slow_parse_refuse_and_hold_as_jax(monkeypatch):
    for spec in SPECS:
        ours = [dataclasses.asdict(r) for r in faults.parse_spec(spec)]
        assert ours == [dataclasses.asdict(r)
                        for r in jax_faults.parse_spec(spec)], spec
    for spec in BAD:
        with pytest.raises(ValueError) as e1:
            faults.parse_spec(spec)
        with pytest.raises(ValueError) as e2:
            jax_faults.parse_spec(spec)
        assert str(e1.value) == str(e2.value)
    assert faults.FAULT_POINTS == jax_faults.FAULT_POINTS
    assert faults.ACTIONS == jax_faults.ACTIONS
    slept = {}
    for pkg, mod in (("port", faults), ("jax", jax_faults)):
        naps = slept[pkg] = []
        monkeypatch.setattr(mod.time, "sleep", naps.append)
        with mod.inject(mod.FaultRule("serve.feed.poll", "stall",
                                      stall_s=0.05, times=2)) as inj:
            mod.fire("serve.feed.poll")
            mod.fire("serve.feed.poll")
            mod.fire("serve.feed.poll")
            naps.append([f["action"] for f in inj.fired])
        with mod.inject(mod.FaultRule("serve.dispatch", "slow",
                                      slow_factor=3.0, times=-1)):
            mod.slow_hold("serve.dispatch", 0.5)  # nothing armed yet
            mod.fire("serve.dispatch")
            mod.slow_hold("serve.dispatch", 0.5)  # 0.5 * (3 - 1)
            mod.slow_hold("serve.dispatch", 0.5)  # consumed: free
        mod.slow_hold("serve.dispatch", 5.0)  # no injector: a no-op
        monkeypatch.undo()
    assert slept["port"] == slept["jax"] == [0.05, 0.05,
                                             ["stall", "stall"], 1.0]


def test_feed_poll_fires_in_the_tail(tmp_path):
    path = str(tmp_path / "feed.jsonl")
    with open(path, "w") as f:
        f.write('{"user": "u0"}\n')
    tail = JsonlTail(path)
    with faults.inject(FaultRule("serve.feed.poll", "kill", at=1)):
        with pytest.raises(InjectedKill):
            tail.poll()
    with faults.inject(FaultRule("serve.feed.poll", "slow",
                                 slow_factor=2.0)) as inj:
        assert [r for r, _ in tail.poll()] == [{"user": "u0"}]
        assert inj.fired[0]["action"] == "slow"


# -- the 2-host subprocess kill drill ---------------------------------------


def _spawn_factory(fabric_dir, ws_root, cfg, n_users, lease_s=5.0):
    def spawn(host_id):
        log = open(hosts.fabric_paths(fabric_dir, host_id)["log"], "ab")
        env = {**os.environ, "PYTHONPATH": REPO}
        env.pop("CETPU_FAULTS", None)
        try:
            return subprocess.Popen(
                [sys.executable, WORKER, fabric_dir, host_id, ws_root,
                 cfg.mode, str(cfg.epochs), str(n_users), str(lease_s),
                 "2"], stdout=log, stderr=subprocess.STDOUT, env=env)
        finally:
            log.close()
    return spawn


def test_two_host_kill_drill_matches_sequential_and_replays_in_jax(
        tmp_path):
    """3 users over 2 worker processes; h0 SIGKILLed the moment the
    journal shows it admitted a user.  The coordinator confirms the death,
    revokes h0 and re-routes its users to h1, where they resume from their
    workspaces; every result equals its sequential port run, which equals
    the JAX sequential run; the compacted journal replays in JAX's
    ``AdmissionJournal`` to the port's state, and both validators pass."""
    cfg = workload.make_cfg("mc", epochs=2)
    specs = workload.user_specs(3)
    seq = workload.sequential_baselines(str(tmp_path), cfg, specs)
    jax_root = tmp_path / "jax"
    jax_root.mkdir()
    jax_seq = jax_workload.sequential_baselines(
        str(jax_root), jax_workload.make_cfg("mc", epochs=2),
        jax_workload.user_specs(3))
    for _, uid, _ in specs:
        assert seq[uid]["trajectory"] == jax_seq[uid]["trajectory"]
    fabric_dir = str(tmp_path / "fabric")
    os.makedirs(fabric_dir)
    jp = os.path.join(fabric_dir, "serve_journal.jsonl")
    journal = AdmissionJournal(jp, compact_bytes=800)
    report = FleetReport()
    t0, killed = time.monotonic(), []

    def chaos(coord):
        if time.monotonic() - t0 > 120:
            raise AssertionError(f"drill wedged: {sorted(coord._unresolved)}")
        st = coord.journal.state
        if not killed and any(h == "h0" and st.last.get(u) == "admit"
                              for u, h in st.assigned.items()):
            coord.hosts["h0"].proc.kill()
            killed.append(True)

    coord = FabricCoordinator(journal, fabric_dir,
                              FabricConfig(hosts=2, lease_s=5.0),
                              report=report, on_poll=chaos)
    try:
        summary = coord.run([u for _, u, _ in specs],
                            _spawn_factory(fabric_dir, str(tmp_path), cfg,
                                           3))
    finally:
        journal.close()
    assert sorted(summary["finished"]) == [u for _, u, _ in specs]
    assert summary["failed"] == [] and summary["poisoned"] == []
    assert summary["revocations"] == 1 and summary["reassignments"] >= 1
    assert summary["hosts"]["h0"] == "revoked"
    down = next(e for e in report.events if e["event"] == "host_down")
    assert down["host"] == "h0" and down["reassigned"] >= 1
    results = workload.read_results(fabric_dir)
    for _, uid, _ in specs:
        assert results[uid]["error"] is None
        assert results[uid]["result"]["trajectory"] == \
            seq[uid]["trajectory"]
        assert results[uid]["result"]["final_mean_f1"] == \
            seq[uid]["final_mean_f1"]
    ours = AdmissionJournal(jp).state
    theirs = jax_journal.AdmissionJournal(jp).state
    assert ours.to_dict() == theirs.to_dict()
    assert ours.finished == {u for _, u, _ in specs} and not ours.pending
    assert ours.hosts["h0"] == "revoke" and ours.hosts["h1"] == "lease"
    assert summary["compactions"] >= 1
    assert validate_journal_file(jp) == []
    assert jax_journal.validate_journal_file(jp) == []
    with open(jp + ".ckpt") as f:
        assert json.load(f)
