"""Coordinator kills at the fabric's decision points, the port against the
JAX package, on the fake-worker harness of ``test_torch_elastic.py``.

Each row fires one decision point's kill through ``faults.inject``, as the
JAX drills do (``tests/test_elastic.py:945-1000``,
``tests/test_remedy.py:536-600``, ``scripts/*_check.sh``): the same script
drives a JAX coordinator and a port coordinator, the killed incarnation is
rerun over fresh fake workers (which drop the re-delivered users the first
incarnation finished, as a worker resolves a complete workspace without
running it), and

- the rerun finishes every user, each exactly once across both
  incarnations' workers;
- both journals replay, in either package, to one ``JournalState``, and
  their records are equal with ``t``, ``pid`` and ``seq`` set aside.

Points: ``fabric.assign`` (a failover's re-route), ``fabric.spawn`` (a
scale-up), ``fabric.drain``, ``fabric.migrate.fence`` and
``fabric.migrate.commit`` (a scale-down's fenced migration),
``fabric.epoch`` (a restarted coordinator's claim) and ``fabric.remedy``
(a rebalance off an overloaded host)."""

import dataclasses

import pytest
import torch

from consensus_entropy_tpu_torch.resilience.faults import FaultRule
from tests.test_torch_elastic import (
    PKGS,
    REMEDY,
    _both,
    _drain_script,
    _fake_fleet,
    _same_journals,
    _setup_skew,
    _summaries_equal,
    _work,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.faults

USERS = [f"u{i}" for i in range(6)]


def _skipping(script, done):
    """``script`` over workers that drop re-delivered users already
    finished (their workspaces complete)."""

    def run(rnd, coord, workers):
        for w in workers.values():
            if not w.dead:
                for uid in list(w.queued):
                    if uid in done:
                        w.queued.remove(uid)
        script(rnd, coord, workers)

    return run


def _kill_then_rerun(tmp_path, cfg_kw, users, pools, make_script, rules, *,
                     kills=1, rerun_script=None):
    """Per package: ``kills`` incarnations die under ``rules`` (the port's
    ``FaultRule``s, each package's injector given their fields), then one
    reruns to the end.  Holds the packages' audit
    trails, summaries and journals equal; returns the port's rerun summary,
    the fired points and the journal's records and state."""
    out = {}
    for name, pkg in PKGS.items():
        root = tmp_path / name
        root.mkdir()
        cfg = pkg.serve.FabricConfig(**cfg_kw)
        incarnations = []
        with pkg.faults.inject(*[dataclasses.asdict(r)
                                 for r in rules]) as inj:
            for _ in range(kills):
                workers = {}
                with pytest.raises(pkg.faults.InjectedKill):
                    _fake_fleet(pkg, root, cfg, users, pools,
                                make_script(pkg), workers=workers)
                incarnations.append(workers)
        fired = [(f["point"], {k: v for k, v in f.items() if k != "point"})
                 for f in inj.fired]
        jp = str(root / "fabric" / "serve_journal.jsonl")
        done = set(pkg.serve.AdmissionJournal(jp).state.finished)
        workers = {}
        summary, _, _, _ = _fake_fleet(
            pkg, root, cfg, users, pools,
            _skipping((rerun_script or make_script)(pkg), done),
            workers=workers)
        assert sorted(done | set(summary["finished"])) == sorted(users)
        ran = [u for ws in [*incarnations, workers] for w in ws.values()
               for u in w.finished]
        assert sorted(ran) == sorted(users)  # exactly one owner each
        out[name] = (summary, fired, done)
    assert out["port"][1] == out["jax"][1]
    assert out["port"][2] == out["jax"][2]
    assert _summaries_equal(out["jax"][0], out["port"][0])
    recs, st = _same_journals(tmp_path)
    assert st.finished == set(users) and not st.pending
    return out["port"][0], out["port"][1], recs, st


def _work_all(pkg):
    def script(rnd, coord, workers):
        if rnd > 2:
            for w in workers.values():
                if not w.dead:
                    _work(w)
    return script


def _failover(pkg):
    """h0 and h1 admit a user each; h1 finishes its own, then dies with
    the rest of its share queued: the coordinator re-routes them."""
    state = {"step": 0}

    def script(rnd, coord, workers):
        h0, h1 = workers.get("h0"), workers.get("h1")
        if state["step"] == 0 and h0 and h1 and h0.queued and h1.queued:
            h0.admit(h0.queued[0])
            h1.admit(h1.queued[0])
            state["step"] = 1
        elif state["step"] == 1:
            h1.finish(h1.admitted[0])
            h1.kill()
            state["step"] = 2
    return script


def test_kill_at_a_failovers_assign(tmp_path):
    pools = {u: 30 for u in USERS}
    summary, fired, recs, st = _kill_then_rerun(
        tmp_path, dict(hosts=2, poll_s=0.01, drain_timeout_s=0.2,
                       placement="load"),
        USERS, pools, _failover,
        [FaultRule("fabric.assign", "kill", at=len(USERS) + 1)],
        rerun_script=_work_all)
    assert [p for p, _ in fired] == ["fabric.assign"]
    assert fired[0][1]["host"] == "h0"  # the dead host's user, re-routed
    assert [r["host"] for r in recs if r["event"] == "revoke"][:1] == ["h1"]


def test_kill_at_a_scale_ups_spawn(tmp_path):
    pools = {u: 30 for u in USERS}
    summary, fired, recs, st = _kill_then_rerun(
        tmp_path, dict(hosts=1, min_hosts=1, max_hosts=2, scale_backlog=2,
                       poll_s=0.01, drain_timeout_s=0.2),
        USERS, pools, _work_all, [FaultRule("fabric.spawn", "kill")])
    assert fired == [("fabric.spawn", {"host": "h1", "reason": "scale_up",
                                       "hit": 1, "action": "kill"})]
    # killed before its record: the rerun decides the scale-up again
    assert [r["host"] for r in recs if r["event"] == "spawn"] == ["h1"]
    assert summary["spawns"] == 1


@pytest.mark.parametrize("point", ["fabric.drain", "fabric.migrate.fence",
                                   "fabric.migrate.commit"])
def test_kill_in_a_fenced_scale_down(tmp_path, point):
    pools = {u: (30 if i % 2 == 0 else 100) for i, u in enumerate(USERS)}
    summary, fired, recs, st = _kill_then_rerun(
        tmp_path, dict(hosts=2, min_hosts=1, max_hosts=2, scale_down_s=0.05,
                       poll_s=0.01, drain_timeout_s=0.2),
        USERS, pools, _drain_script, [FaultRule(point, "kill")])
    assert [p for p, _ in fired] == [point]
    events = [r["event"] for r in recs]
    # the decision is journaled once, by the incarnation that lived
    assert events.count("drain") == 1 and "drain_done" in events
    assert len(st.fleet_hosts()) == 1 and st.draining_hosts() == []


def test_kill_at_a_restarted_coordinators_epoch_claim(tmp_path):
    """The first incarnation dies at a failover's re-route, the second at
    its epoch claim, before the record: the third claims the same epoch
    number the second would have, and finishes."""
    pools = {u: 30 for u in USERS}
    summary, fired, recs, st = _kill_then_rerun(
        tmp_path, dict(hosts=2, poll_s=0.01, drain_timeout_s=0.2,
                       placement="load"),
        USERS, pools, _failover,
        [FaultRule("fabric.assign", "kill", at=len(USERS) + 1),
         FaultRule("fabric.epoch", "kill", at=2)], kills=2,
        rerun_script=_work_all)
    assert [p for p, _ in fired] == ["fabric.assign", "fabric.epoch"]
    assert [r["epoch"] for r in recs if r["event"] == "epoch"] == [1, 2]


def test_kill_at_a_rebalances_remedy(tmp_path):
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

    summary, fired, recs, st = _kill_then_rerun(
        tmp_path, dict(REMEDY, remedy_cooldown_s=0.0), users, pools,
        make_script, [FaultRule("fabric.remedy", "kill")],
        rerun_script=_work_all)
    assert [p for p, _ in fired] == ["fabric.remedy"]
    assert fired[0][1]["action"] == "rebalance"
    # fired before its record: only the rerun's decisions are journaled
    assert st.fleet_hosts() == ["h0", "h1"]


def test_a_refused_evict_racing_a_fence_release_still_moves_the_user(
        tmp_path):
    """The fence deadline demotes a fence to an evict; the worker's
    checkpoint release wins the race, so it refuses the evict (``drop``,
    ok false: the user is no longer held) and then acks the fence.  The
    port's coordinator commits the move on that late fence ack and every
    user finishes.  (The JAX package's coordinator drops the fallback on
    the refused ack and never re-routes the released user: ROADMAP C17;
    seen as a wedged ``remedy_check.sh`` leg 2 on real workers.)"""
    from consensus_entropy_tpu_torch import serve

    users = [f"u{i}" for i in range(8)]
    pools = {u: 30 for u in users}
    state = {"setup": False, "raced": []}

    def script(rnd, coord, workers):
        if not _setup_skew(state, users, workers):
            return
        h0 = workers["h0"]
        _work(workers["h1"])
        for uid in list(h0.evict_pending):
            h0.evict_pending.remove(uid)
            h0._event({"event": "drop", "user": uid, "ok": False})
            h0.release(uid, gen=1)
            state["raced"].append(uid)
        if coord.fences_timed_out and not coord._migrating \
                and not coord._fencing:
            _work(h0)

    summary, _, workers, fabric_dir = _fake_fleet(
        PKGS["port"], tmp_path, serve.FabricConfig(
            **dict(REMEDY, remedy_cooldown_s=600.0, fence_deadline_s=0.05)),
        users, pools, script)
    assert state["raced"] and summary["fence_timeouts"] == 1
    assert sorted(summary["finished"]) == users
    ran = [u for w in workers.values() for u in w.finished]
    assert sorted(ran) == users
    moved = state["raced"][0]
    assert moved in workers["h1"].finished


@pytest.mark.parametrize("ack_polls", [0, 1])
def test_a_fence_ack_read_before_its_deadline_check_commits(tmp_path,
                                                           ack_polls):
    """The fence deadline's race (ROADMAP C21) through the coordinators'
    injected clock: the deadline (1 ms) is shorter than one read of the
    clock (10 ms), so by the first poll after the fence it has passed.
    Each poll reads the hosts' acks before it checks the deadlines: an ack
    that lands within that poll gap (``ack_polls`` 0) commits the fence
    and no timeout is counted; an ack one poll later (1) finds the fence
    demoted (a timeout, an evict sent), and the boundary release still
    commits the move through the fallback, the evict refused.  Both
    packages decide the same, record for record."""
    users = [f"u{i}" for i in range(8)]
    pools = {u: 30 for u in users}

    def make_script(pkg):
        state = {"setup": False, "seen": {}}

        def script(rnd, coord, workers):
            if not _setup_skew(state, users, workers):
                return
            h0 = workers["h0"]
            _work(workers["h1"])
            for uid in list(h0.fence_pending):
                if rnd - state["seen"].setdefault(uid, rnd) >= ack_polls:
                    h0.release(uid, gen=1)
            for uid in list(h0.evict_pending):
                # the fence's release came first: no session to evict
                h0.evict_pending.remove(uid)
                h0._event({"event": "drop", "user": uid, "ok": False})
            if coord.remedies and not coord._migrating \
                    and not coord._fencing:
                _work(h0)
        return script

    (summary, _, workers, _), (recs, _) = _both(
        tmp_path, dict(REMEDY, remedy_cooldown_s=600.0,
                       fence_deadline_s=0.001), users, pools, make_script)
    assert summary["remedies"] == 1 and summary["fences"] == 1
    assert summary["fence_timeouts"] == ack_polls
    actions = [r["action"] for r in recs if r["event"] == "remedy"]
    assert actions == ["rebalance"] + ["fence_timeout"] * ack_polls
    moved = [r["user"] for r in recs if r["event"] == "fence"]
    assert len(moved) == 1 and moved[0] in workers["h1"].finished
