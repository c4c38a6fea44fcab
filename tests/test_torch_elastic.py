"""The port's elastic and self-healing fabric against the JAX package's,
in round-driven fake-worker drills on the CPU.

The test plays the workers (a port copy of ``_FakeWorker`` and
``_fake_fleet``, JAX ``tests/test_elastic.py:572-727``, with the remedy
drills' evict verb and the gray drills' step-wall beat): each one beats
its lease, consumes its assignment feed and appends admit, finish and
ack records to its event WAL, all on the coordinator's thread.  The same
script drives a JAX coordinator and a port coordinator, each over its
own package's feeds and tails, with one injected clock that advances a
fixed step per read, so liveness, hysteresis and deadlines fire at the
same rounds in both.  Scenarios: join and rebalance, a coordinator kill
mid-rebalance and its rerun, scale-down with a fenced migration,
stillborn spawns, operator adoption, the fence deadline, remedy and the
gray ladder.  Both journals replay (in either package) to equal
``JournalState``s, and their record sequences are equal with ``t``,
``pid`` and ``seq`` set aside (tolerance 0).  Then the CLI: ``amg_test``
refuses what JAX's refuses, with the same words."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

import consensus_entropy_tpu.obs.alerts as jax_alerts
import consensus_entropy_tpu.resilience.faults as jax_faults
import consensus_entropy_tpu.serve as jax_serve
import consensus_entropy_tpu.serve.hosts as jax_hosts
from consensus_entropy_tpu.cli import amg_test as jax_amg_test
import consensus_entropy_tpu_torch.obs.alerts as port_alerts
import consensus_entropy_tpu_torch.resilience.faults as port_faults
import consensus_entropy_tpu_torch.serve as port_serve
import consensus_entropy_tpu_torch.serve.hosts as port_hosts
from consensus_entropy_tpu_torch.cli import amg_test

torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(serve=jax_serve, hosts=jax_hosts,
                                 faults=jax_faults, alerts=jax_alerts),
    "port": types.SimpleNamespace(serve=port_serve, hosts=port_hosts,
                                  faults=port_faults, alerts=port_alerts),
}
#: record fields that name a wall time, a process or a position in the
#: file rather than a decision
VOLATILE = ("t", "pid", "seq")


class _Clock:
    """The coordinator's injected wall clock: each read advances it by
    ``step`` s, so two coordinators that read it in the same order see the
    same times."""

    def __init__(self, step=0.01):
        self.now = 1_000_000.0
        self.step = step

    def __call__(self):
        self.now += self.step
        return self.now


class _FakeWorker:
    """One worker host played by the test: beats its lease (stamped by
    the injected clock, carrying ``step_ema_s``), consumes its assignment
    feed and appends admit / finish / ack records to its event WAL.
    Popen-shaped for the coordinator.  Fences of admitted users wait for
    :meth:`release`, evicts for :meth:`force_release`."""

    def __init__(self, pkg, fabric_dir, host_id, clock, step_ema_s=0.5):
        self.host_id = host_id
        self.clock = clock
        self.step_ema_s = step_ema_s
        self.paths = pkg.hosts.fabric_paths(fabric_dir, host_id)
        self.feed = pkg.serve.JsonlTail(self.paths["assign"])
        self.queued: list = []
        self.admitted: list = []
        self.finished: list = []
        self.edges: list = []
        self.fence_pending: list = []
        self.evict_pending: list = []
        self.dead = False
        self.draining = False
        self._rc = None
        self.beat()

    @property
    def pid(self):
        return os.getpid()

    def poll(self):
        return self._rc

    def kill(self):
        self._rc = -9
        self.dead = True

    def wait(self, timeout=None):
        return self._rc

    def beat(self):
        if self.dead:
            return
        tmp = self.paths["lease"] + ".tmp"
        with open(tmp, "wb") as f:
            f.write(json.dumps(
                {"host": self.host_id, "pid": os.getpid(),
                 "t": self.clock(),
                 "step_ema_s": self.step_ema_s}).encode())
        os.replace(tmp, self.paths["lease"])

    def _event(self, rec):
        with open(self.paths["events"], "ab") as f:
            f.write((json.dumps(rec) + "\n").encode())

    def pump(self):
        if self.dead:
            return
        self.beat()
        for rec, _off in self.feed.poll():
            if rec.get("close"):
                self._rc = 0
                continue
            if isinstance(rec.get("edges"), list):
                self.edges.append(tuple(rec["edges"]))
                continue
            if rec.get("drain"):
                self.draining = True
                continue
            if rec.get("fence") is not None:
                uid = str(rec["fence"])
                if uid in self.queued:
                    self.queued.remove(uid)
                    self._event({"event": "fence", "user": uid,
                                 "ok": True})
                elif uid in self.admitted:
                    self.fence_pending.append(uid)
                else:
                    self._event({"event": "fence", "user": uid,
                                 "ok": False})
                continue
            if rec.get("drop") is not None:
                uid = str(rec["drop"])
                if rec.get("evict") and uid in self.admitted:
                    self.evict_pending.append(uid)
                    continue
                ok = uid in self.queued
                if ok:
                    self.queued.remove(uid)
                self._event({"event": "drop", "user": uid, "ok": ok})
                continue
            if rec.get("user") is not None:
                self.queued.append(str(rec["user"]))
        if self.draining and not self.queued and not self.admitted \
                and not self.fence_pending and self._rc is None:
            self._rc = 0

    def admit(self, uid):
        self.queued.remove(uid)
        self.admitted.append(uid)
        self._event({"event": "admit", "user": uid})

    def release(self, uid, gen=1):
        self.admitted.remove(uid)
        self.fence_pending.remove(uid)
        self._event({"event": "fence", "user": uid, "ok": True,
                     "gen": gen})

    def force_release(self, uid, gen=2):
        self.admitted.remove(uid)
        self.evict_pending.remove(uid)
        self._event({"event": "drop", "user": uid, "ok": True,
                     "gen": gen})

    def finish(self, uid):
        self.admitted.remove(uid)
        self.finished.append(uid)
        self._event({"event": "finish", "user": uid})

    def journal_sketch(self, pkg, pools):
        from consensus_entropy_tpu_torch.obs.metrics import QuantileSketch

        sk = QuantileSketch()
        for p in pools:
            sk.add(float(p))
        self._event({"event": "planner", "edges": [],
                     "sketch": sk.to_dict()})


def _work(w):
    for uid in list(w.admitted):
        w.finish(uid)
    for uid in list(w.queued):
        w.admit(uid)


class _Status:
    """A status writer that keeps every payload it is asked to write."""

    def __init__(self):
        self.payloads = []

    def maybe_write(self, payload_fn):
        self.payloads.append(payload_fn())


def _fake_fleet(pkg, root, config, users, pools, script, *, workers=None,
                slow=(), alerts=None, clock=None, status=None):
    """A coordinator of ``pkg`` over fake workers; ``script(round, coord,
    workers)`` runs after every worker pumped, each poll."""
    fabric_dir = str(root / "fabric")
    os.makedirs(fabric_dir, exist_ok=True)
    journal = pkg.serve.AdmissionJournal(
        os.path.join(fabric_dir, "serve_journal.jsonl"))
    workers = {} if workers is None else workers
    clock = clock or _Clock()

    def spawn(host_id):
        workers[host_id] = _FakeWorker(
            pkg, fabric_dir, host_id, clock,
            step_ema_s=9.0 if host_id in slow else 0.5)
        return workers[host_id]

    state = {"round": 0}

    def on_poll(coord):
        state["round"] += 1
        if state["round"] > 2000:
            raise AssertionError("fake drill wedged: "
                                 f"unresolved={sorted(coord._unresolved)}")
        for w in list(workers.values()):
            w.pump()
        script(state["round"], coord, workers)

    coord = pkg.serve.FabricCoordinator(
        journal, fabric_dir, config, on_poll=on_poll, clock=clock,
        alerts=alerts, status=status)
    try:
        summary = coord.run(users, spawn, pools=pools)
    finally:
        journal.close()
    return summary, coord, workers, fabric_dir


def _records(fabric_dir):
    from consensus_entropy_tpu_torch.resilience import io as dio

    out = []
    with open(os.path.join(fabric_dir, "serve_journal.jsonl"), "rb") as f:
        for line in f:
            status, rec = dio.parse_frame(line)
            assert status != "corrupt", line
            if isinstance(rec, dict) and not dio.is_header(rec):
                out.append({k: v for k, v in rec.items()
                            if k not in VOLATILE})
    return out


def _same_journals(tmp_path):
    """Both runs' journals: equal records (volatile fields aside), and
    each replays in both packages to one ``JournalState``; both
    validators pass."""
    jax_dir, port_dir = (str(tmp_path / p / "fabric")
                         for p in ("jax", "port"))
    assert _records(port_dir) == _records(jax_dir)
    states = []
    for d in (jax_dir, port_dir):
        jp = os.path.join(d, "serve_journal.jsonl")
        for pkg in PKGS.values():
            states.append(pkg.serve.AdmissionJournal(jp).state.to_dict())
            assert pkg.serve.validate_journal_file(jp) == []
    for s in states[1:]:
        assert s == states[0]
    return _records(port_dir), port_serve.JournalState.from_dict(states[0])


def _summaries_equal(a, b):
    """Equal summaries, wall-clock fields aside."""
    drop = ("wall_s", "t")
    return ({k: v for k, v in a.items() if k not in drop}
            == {k: v for k, v in b.items() if k not in drop})


def _both(tmp_path, cfg_kw, users, pools, make_script, *,
          with_status=False, **kw):
    """The scenario through both coordinators; ``with_status`` gives each a
    status limb and an alert watcher, whose payloads (one a poll) must be
    equal too (they read the clock, so they shift the rounds), the port's
    ``alert_sink_errors`` count, 0, aside."""
    out, payloads = {}, {}
    for name, pkg in PKGS.items():
        root = tmp_path / name
        root.mkdir(exist_ok=True)
        status = _Status() if with_status else None
        alerts = pkg.alerts.AlertWatcher() if with_status else None
        out[name] = _fake_fleet(pkg, root,
                                pkg.serve.FabricConfig(**cfg_kw), users,
                                pools, make_script(pkg), status=status,
                                alerts=alerts, **kw)
        payloads[name] = status.payloads if with_status else None
    for p in payloads["port"] or ():
        # the port's count of alert-sink failures (no sink here)
        assert p.pop("alert_sink_errors") == 0
    assert payloads["port"] == payloads["jax"]
    assert payloads["port"] or not with_status
    assert _summaries_equal(out["jax"][0], out["port"][0])
    for name in PKGS:
        summary, _, workers, _ = out[name]
        assert sorted(summary["finished"]) == sorted(users)
        ran = [u for w in workers.values() for u in w.finished]
        assert sorted(ran) == sorted(users)  # exactly one owner each
    return out["port"], _same_journals(tmp_path)


def test_join_rebalance_and_fleet_edges_match(tmp_path):
    users = [f"u{i}" for i in range(6)]
    pools = {u: (30 if i % 2 == 0 else 100) for i, u in enumerate(users)}

    def make_script(pkg):
        def script(rnd, coord, workers):
            h0 = workers.get("h0")
            if rnd == 2 and h0 and not h0.admitted and h0.queued:
                h0.admit(h0.queued[0])
            if rnd == 4 and h0:
                h0.journal_sketch(pkg, [pools[u] for u in users])
            if rnd > 6:
                for w in workers.values():
                    _work(w)
        return script

    (summary, _, workers, _), (recs, st) = _both(
        tmp_path, dict(hosts=1, min_hosts=1, max_hosts=2, scale_backlog=2,
                       poll_s=0.01, planner_epoch=4, drain_timeout_s=0.2),
        users, pools, make_script, with_status=True)
    assert summary["spawns"] >= 1 and summary["joins"] >= 1
    assert summary["migrations"] >= 1
    assert st.fleet_hosts() == ["h0", "h1"] and st.pools == pools
    assert summary["fleet_planner"]["edges"]
    assert any(r["event"] == "drop" for r in recs)


def test_coordinator_kill_mid_rebalance_replays_alike(tmp_path):
    users = [f"u{i}" for i in range(6)]
    pools = {u: 30 for u in users}
    cfg_kw = dict(hosts=1, min_hosts=1, max_hosts=2, scale_backlog=2,
                  poll_s=0.01, drain_timeout_s=0.2)
    for name, pkg in PKGS.items():
        root = tmp_path / name
        root.mkdir()

        def script1(rnd, coord, workers, pkg=pkg):
            if coord._migrating:
                raise pkg.faults.InjectedKill("coordinator killed "
                                              "mid-rebalance")

        with pytest.raises(BaseException, match="mid-rebalance"):
            _fake_fleet(pkg, root, pkg.serve.FabricConfig(**cfg_kw), users,
                        pools, script1)

        def script2(rnd, coord, workers):
            if rnd > 4:
                for w in workers.values():
                    _work(w)

        summary, _, workers, _ = _fake_fleet(
            pkg, root, pkg.serve.FabricConfig(**cfg_kw), users, pools,
            script2)
        assert sorted(summary["finished"]) == users
        assert set(workers) == {"h0", "h1"}
    recs, st = _same_journals(tmp_path)
    assert st.finished == set(users) and not st.pending
    assert [r["event"] for r in recs].count("epoch") == 2


def _drain_script(pkg):
    def script(rnd, coord, workers):
        if rnd == 2:
            for w in workers.values():
                if w.queued and not w.dead:
                    w.admit(w.queued[0])
        for w in workers.values():
            for uid in list(w.fence_pending):
                w.release(uid, gen=1)
        live = sum(1 for h in coord.hosts.values() if h.alive)
        if coord.drains or live <= coord.config.min_hosts:
            for w in workers.values():
                if not (w.dead or w.draining):
                    _work(w)
    return script


def test_scale_down_fenced_migration_matches(tmp_path):
    users = [f"u{i}" for i in range(6)]
    pools = {u: (30 if i % 2 == 0 else 100) for i, u in enumerate(users)}
    (summary, _, _, _), (recs, st) = _both(
        tmp_path, dict(hosts=2, min_hosts=1, max_hosts=2, scale_down_s=0.05,
                       poll_s=0.01, drain_timeout_s=0.2),
        users, pools, _drain_script)
    assert summary["drains"] == 1 and summary["fences"] >= 1
    victim = [h for h, s in summary["hosts"].items() if s == "drained"][0]
    kinds = [(r["event"], r.get("host")) for r in recs]
    i_drain = kinds.index(("drain", victim))
    fence = next(i for i, r in enumerate(recs) if i > i_drain
                 and r["event"] == "fence" and r.get("gen") == 1)
    moved = recs[fence]["user"]
    assert any(r["event"] == "assign" and r["user"] == moved
               and r["host"] != victim for r in recs[fence:])
    assert kinds.index(("drain_done", victim)) > fence
    assert st.hosts[victim] == "drain_done"


def test_stillborn_spawns_raise_alike(tmp_path):
    out = {}
    for name, pkg in PKGS.items():
        fabric_dir = str(tmp_path / name / "fabric")
        os.makedirs(fabric_dir)
        journal = pkg.serve.AdmissionJournal(
            os.path.join(fabric_dir, "serve_journal.jsonl"))
        spawned = []

        class _Stillborn:
            pid = None

            def poll(self):
                return 1

            def kill(self):
                pass

            def wait(self, timeout=None):
                return 1

        def spawn(host_id, spawned=spawned):
            spawned.append(host_id)
            return _Stillborn()

        coord = pkg.serve.FabricCoordinator(
            journal, fabric_dir,
            pkg.serve.FabricConfig(hosts=1, min_hosts=1, max_hosts=2,
                                   poll_s=0.01, drain_timeout_s=0.1),
            clock=_Clock())
        with pytest.raises(Exception, match="first heartbeat") as e:
            coord.run(["u0"], spawn)
        journal.close()
        out[name] = (spawned, type(e.value).__name__, str(e.value))
        assert 1 <= len(spawned) <= 6
    assert out["port"] == out["jax"]
    _same_journals(tmp_path)


def test_operator_adoption_matches(tmp_path):
    """A fresh lease for an unknown host is adopted (spawn reason
    ``operator``, lease journaled, a pid-only handle), a stale one is
    ignored, in both coordinators."""
    volunteer = subprocess.Popen([sys.executable, "-c",
                                  "import time; time.sleep(60)"])
    out = {}
    try:
        for name, pkg in PKGS.items():
            fabric_dir = str(tmp_path / name / "fabric")
            os.makedirs(fabric_dir)
            journal = pkg.serve.AdmissionJournal(
                os.path.join(fabric_dir, "serve_journal.jsonl"))
            clock = _Clock()
            coord = pkg.serve.FabricCoordinator(
                journal, fabric_dir,
                pkg.serve.FabricConfig(hosts=1, min_hosts=1, max_hosts=3,
                                       poll_s=0.01), clock=clock)
            for hid, fresh in (("h7", True), ("h8", False)):
                lease = pkg.hosts.fabric_paths(fabric_dir, hid)["lease"]
                with open(lease, "wb") as f:
                    f.write(json.dumps({
                        "host": hid, "pid": volunteer.pid,
                        "t": clock() - (0.0 if fresh else 3600.0)}).encode())
            coord._adopt_operator_hosts()
            out[name] = (sorted(coord.hosts), coord.spawns,
                         coord.hosts["h7"].proc.poll(),
                         journal.state.hosts)
            journal.close()
    finally:
        volunteer.kill()
        volunteer.wait()
    assert out["port"] == out["jax"]
    assert out["port"][:3] == (["h7"], 1, None)
    _, st = _same_journals(tmp_path)
    assert "h7" in st.fleet_hosts()


def _setup_skew(state, users, workers):
    if state["setup"]:
        return True
    h0, h1 = workers.get("h0"), workers.get("h1")
    if not (h0 and h1):
        return False
    if len(h0.queued) + len(h1.queued) == len(users):
        state["setup"] = True
        for uid in list(h0.queued)[:-1]:
            h0.admit(uid)
        for uid in list(h1.queued):
            h1.admit(uid)
    return state["setup"]


REMEDY = dict(hosts=2, min_hosts=2, max_hosts=2, poll_s=0.01,
              drain_timeout_s=0.2, placement="load", remedy=True,
              remedy_hold_s=0.0, remedy_skew=2)


def test_remedy_rebalance_matches(tmp_path):
    users = [f"u{i}" for i in range(8)]
    pools = {u: 30 for u in users}

    def make_script(pkg):
        state = {"setup": False}

        def script(rnd, coord, workers):
            if not _setup_skew(state, users, workers):
                return
            for w in workers.values():
                for uid in list(w.fence_pending):
                    w.release(uid, gen=1)
            _work(workers["h1"])
            if coord.remedies and not coord._migrating \
                    and not coord._fencing:
                _work(workers["h0"])
        return script

    (summary, _, _, _), (recs, st) = _both(
        tmp_path, dict(REMEDY, remedy_cooldown_s=0.0), users, pools,
        make_script)
    assert summary["remedies"] == 1 and summary["fences"] == 1
    assert summary["drains"] == 0 and summary["revocations"] == 0
    assert [(r["host"], r["action"]) for r in recs
            if r["event"] == "remedy"] == [("h0", "rebalance")]
    assert st.fleet_hosts() == ["h0", "h1"]


@pytest.mark.parametrize("winner", ["evict_ack", "late_fence_ack"])
def test_fence_deadline_matches(tmp_path, winner):
    users = [f"u{i}" for i in range(8)]
    pools = {u: 30 for u in users}

    def make_script(pkg):
        state = {"setup": False, "late_acked": False}

        def script(rnd, coord, workers):
            if not _setup_skew(state, users, workers):
                return
            h0 = workers["h0"]
            _work(workers["h1"])
            if winner == "evict_ack":
                for uid in list(h0.evict_pending):
                    h0.force_release(uid, gen=2)
                if coord.fences_timed_out and not coord._migrating \
                        and not state["late_acked"] and h0.fence_pending:
                    state["late_acked"] = True
                    for uid in list(h0.fence_pending):
                        h0.fence_pending.remove(uid)
                        h0._event({"event": "fence", "user": uid,
                                   "ok": True, "gen": 3})
            elif coord.fences_timed_out and h0.evict_pending:
                for uid in list(h0.evict_pending):
                    h0.evict_pending.remove(uid)
                    h0.release(uid, gen=1)
            if coord.fences_timed_out and not coord._migrating \
                    and not coord._fencing:
                _work(h0)
        return script

    (summary, _, _, _), (recs, _) = _both(
        tmp_path, dict(REMEDY, remedy_cooldown_s=600.0,
                       fence_deadline_s=0.05), users, pools, make_script)
    assert summary["remedies"] == 1 and summary["fence_timeouts"] == 1
    assert summary["fences"] == (0 if winner == "evict_ack" else 1)
    assert [r["action"] for r in recs if r["event"] == "remedy"] == [
        "rebalance", "fence_timeout"]


def test_gray_ladder_matches(tmp_path):
    """h0 advertises a step wall 18x its peers': both coordinators journal
    one probation, then one gray drain, and raise the same alerts."""
    users = [f"u{i}" for i in range(9)]
    pools = {u: 30 for u in users}

    def make_script(pkg):
        def script(rnd, coord, workers):
            for hid, w in workers.items():
                if hid != "h0":
                    _work(w)
        return script

    class _Rec:
        def __init__(self):
            self.events = []

        def event(self, kind, /, **kw):
            self.events.append((kind, kw))

    out = {}
    for name, pkg in PKGS.items():
        root = tmp_path / name
        root.mkdir()
        rep = _Rec()
        out[name] = _fake_fleet(
            pkg, root, pkg.serve.FabricConfig(
                hosts=3, min_hosts=3, max_hosts=3, poll_s=0.01,
                drain_timeout_s=0.2, placement="load", gray=True,
                gray_ratio=3.0, gray_min_s=1.0, gray_hold_s=0.0,
                gray_drain_s=0.03, gray_clear_s=600.0), users, pools,
            make_script(pkg), slow=("h0",),
            alerts=pkg.alerts.AlertWatcher(rep)), rep.events
    (jax_run, jax_alerts_seen), (port_run, port_alerts_seen) = (
        out["jax"], out["port"])
    assert _summaries_equal(jax_run[0], port_run[0])
    assert port_alerts_seen == jax_alerts_seen
    summary = port_run[0]
    assert summary["probations"] == 1 and summary["gray_drains"] == 1
    assert not port_run[2]["h0"].finished
    recs, st = _same_journals(tmp_path)
    assert [(r["host"], r["on"]) for r in recs
            if r["event"] == "probation"] == [("h0", True)]
    assert st.probation == {"h0"}


def test_fabric_target_submits_and_disconnects_alike(tmp_path):
    """A live fabric (``keep_open``) fed through ``FabricTarget``: users
    arrive, one in flight is disconnected (an evict drop, acked at its
    next step) and reconnected, and the intake closes once all are
    submitted; both coordinators journal the same records."""
    from consensus_entropy_tpu.workload import FabricTarget as JaxTarget
    from consensus_entropy_tpu_torch.workload import FabricTarget

    users = [f"u{i}" for i in range(4)]
    out = {}
    for name, pkg in PKGS.items():
        fabric_dir = str(tmp_path / name / "fabric")
        os.makedirs(fabric_dir)
        journal = pkg.serve.AdmissionJournal(
            os.path.join(fabric_dir, "serve_journal.jsonl"))
        clock, workers, state = _Clock(), {}, {"round": 0, "step": 0}

        def spawn(host_id, pkg=pkg, clock=clock, workers=workers,
                  fabric_dir=fabric_dir):
            workers[host_id] = _FakeWorker(pkg, fabric_dir, host_id, clock)
            return workers[host_id]

        def on_poll(coord, workers=workers, state=state):
            state["round"] += 1
            assert state["round"] < 2000, sorted(coord._unresolved)
            for w in workers.values():
                w.pump()
            target = state["target"]
            if state["round"] == 2:
                for u in users:
                    target.submit(u, cls="batch", pool=30)
            h0 = workers.get("h0")
            if state["step"] == 0 and h0 and "u0" in h0.queued:
                h0.admit("u0")
                target.disconnect("u0")
                state["step"] = 1
            if h0 and "u0" in h0.evict_pending:
                h0.force_release("u0", gen=0)
                state["step"] = 2
            if state["step"] == 2 and "u0" in coord._parked \
                    and not coord._evict_pending:
                target.submit("u0", cls="batch", pool=30)
                target.close()
                state["step"] = 3
            if state["step"] == 3:
                for w in workers.values():
                    _work(w)

        coord = pkg.serve.FabricCoordinator(
            journal, fabric_dir,
            pkg.serve.FabricConfig(hosts=2, poll_s=0.01,
                                   drain_timeout_s=0.2),
            on_poll=on_poll, clock=clock)
        state["target"] = (FabricTarget if name == "port"
                           else JaxTarget)(coord)
        try:
            summary = coord.run([], spawn, keep_open=True)
        finally:
            journal.close()
        out[name] = (summary["finished"], summary["disconnects"],
                     summary["reconnects"])
        ran = [u for w in workers.values() for u in w.finished]
        assert sorted(ran) == users
    assert out["port"] == out["jax"]
    assert out["port"] == (users, 1, 1)
    _same_journals(tmp_path)


# -- the CLI's fabric flags ---------------------------------------------------


@pytest.mark.parametrize("extra", [
    ["--min-hosts", "2"],
    ["--serve", "1", "--min-hosts", "2"],
    ["--serve", "1", "--hosts", "2", "--min-hosts", "3", "--max-hosts", "2"],
    ["--serve", "1", "--hosts", "5", "--min-hosts", "1", "--max-hosts", "4"],
    ["--serve", "1", "--scale-down-s", "5"],
    ["--serve", "1", "--hosts", "2", "--scale-down-s", "-1",
     "--min-hosts", "2"],
    ["--serve", "1", "--remedy"],
    ["--serve", "1", "--fence-deadline-s", "2"],
    ["--serve", "1", "--hosts", "0"],
    ["--serve", "1", "--hosts", "2", "--lease-s", "0"],
    ["--serve", "1", "--hosts", "2", "--no-serve-journal"],
    ["--serve", "1", "--hosts", "2", "--mesh", "2", "--mesh-devices", "2"],
    ["--serve", "1", "--hosts", "2", "--mesh-devices", "x"],
    ["--serve", "1", "--hosts", "2", "--mesh-devices", "1,2,3"],
    ["--serve", "1", "--hosts", "2", "--placement", "bucket",
     "--drain-host", "h1"],
    ["--serve", "1", "--hosts", "2", "--min-hosts", "2",
     "--remedy-skew", "0", "--remedy"],
    ["--serve", "1", "--fabric-worker", "h0"],
    ["--hosts", "2"],
], ids=["min-no-serve", "min-no-hosts", "min-over-max", "hosts-outside",
        "scale-down-no-hosts", "scale-down-negative", "remedy-no-hosts",
        "deadline-no-hosts", "hosts-0", "lease-0", "no-journal",
        "mesh-twice", "mesh-devices-x", "mesh-devices-shape",
        "drain-not-elastic", "remedy-skew-0", "worker-no-dir",
        "hosts-no-serve"])
def test_fabric_flag_errors_are_the_jax_clis(tmp_path, capsys, extra):
    base = ["-q", "1", "-e", "1", "-n", "1", "-m", "mc",
            "--models-root", str(tmp_path)]
    assert jax_amg_test.main(base + extra) == 1
    theirs = capsys.readouterr().out
    assert amg_test.main(base + extra) == 1
    assert capsys.readouterr().out == theirs
    assert "--" in theirs or "fabric" in theirs
