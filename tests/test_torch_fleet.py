"""The port's fleet scheduler against its sequential loop and the JAX
package's ``FleetScheduler``, on the CPU.

A 3-user cohort of GaussianNB + SGD committees (fitted by scikit-learn and
carried across by ``convert.host_members_from_jax``) runs through the
port's ``FleetScheduler``, through each user's sequential ``drive_inline``
run and through the JAX ``FleetScheduler``.  Per mode, each user's
trajectory, ``metrics.jsonl`` and ``al_state.json`` equal its sequential
run's (tolerance 0: the same statements on the same values), and its
queried songs and F1s equal the JAX fleet's (tolerance 0, as the
sequential loops already are).  Then the engine's failure paths: eviction
and resume at the pinned pad, eviction without a factory failing only that
user, preemption leaving every workspace resumable, occupancy over active
slots only, abort joining the checkpointers before the shared pool shuts
down, the shared executor's per-session order, a failed stacked dispatch
served per user, one dispatch round stacking a group (its rows the single
calls, its uploads graded), the open / admit / pump lifecycle over two
bucket widths and the depth dial; and a GBDT member that trains bit for bit as its
sequential fit under three concurrent host workers."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.al.loop import UserData as JaxUserData
from consensus_entropy_tpu.config import ALConfig as JaxConfig
from consensus_entropy_tpu.fleet import FleetScheduler as JaxScheduler
from consensus_entropy_tpu.fleet import FleetUser as JaxUser
from consensus_entropy_tpu.models.committee import Committee as JaxCommittee
from consensus_entropy_tpu.models.committee import FramePool as JaxPool
from consensus_entropy_tpu.models.gbdt import NativeGBDTMember as JaxGBDT
from consensus_entropy_tpu.models.sklearn_members import GNBMember as JaxGNB
from consensus_entropy_tpu.models.sklearn_members import SGDMember as JaxSGD
from consensus_entropy_tpu_torch import convert
from consensus_entropy_tpu_torch.al import state as al_state
from consensus_entropy_tpu_torch.al import workspace
from consensus_entropy_tpu_torch.al.loop import (
    ALLoop,
    AsyncCheckpointer,
    UserData,
)
from consensus_entropy_tpu_torch.config import ALConfig
from consensus_entropy_tpu_torch.fleet import (
    FleetReport,
    FleetScheduler,
    FleetUser,
    UserSession,
)
from consensus_entropy_tpu_torch.models.committee import Committee, FramePool
from consensus_entropy_tpu_torch.resilience import faults
from consensus_entropy_tpu_torch.resilience.faults import FaultRule
from consensus_entropy_tpu_torch.resilience.preemption import Preempted

torch.set_num_threads(1)

MODES = ["mc", "hc", "mix", "rand", "wmc"]
N_USERS, EPOCHS, Q, SEED = 3, 3, 4, 7


def _raw_user(seed, n_songs):
    """Frames (F=10, 3-6 a song), labels, hc rows and the fitted JAX
    members of one synthetic user."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4, 10)).astype(np.float32) * 2.5
    rows, sids, labels = [], [], {}
    for i in range(n_songs):
        sid, c = f"song{i:03d}", int(rng.integers(0, 4))
        labels[sid] = c
        k = int(rng.integers(3, 7))
        rows.append(centers[c]
                    + rng.standard_normal((k, 10)).astype(np.float32))
        sids += [sid] * k
    x = np.vstack(rows)
    counts = rng.integers(1, 30, size=(n_songs, 4))
    hc = np.round(counts / counts.sum(1, keepdims=True), 3).astype(
        np.float32)
    y = np.array([labels[s] for s in sids])
    noisy = x + rng.standard_normal(x.shape).astype(np.float32) * 3
    return x, sids, labels, hc, noisy, y


@pytest.fixture(scope="module")
def users():
    """Three users of 26, 30 and 28 songs (the cohort pads to 30)."""
    return [_raw_user(100 + i, n) for i, n in enumerate((26, 30, 28))]


def _jax_members(user, *, victim=False, gbdt=False):
    _, _, _, _, noisy, y = user
    members = [JaxGNB("gnb.it_0").fit(noisy, y),
               JaxSGD("sgd.victim" if victim else "sgd.it_0",
                      seed=0).fit(noisy, y)]
    if gbdt:
        members.append(JaxGBDT("xgb.it_0", n_estimators=3,
                               update_estimators=2).fit(noisy, y))
    return members


def _data(user, uid):
    x, sids, labels, hc, _, _ = user
    return UserData(uid, FramePool(x, sids), labels, hc_rows=hc)


def _committee(user, **kw):
    min_members = 3 if kw.get("victim") else 1
    return Committee(convert.host_members_from_jax(_jax_members(user, **kw)),
                     min_members=min_members)


def _cfg(mode="mc", epochs=EPOCHS):
    # float32 checkpoints: a resume replays bit for bit
    return ALConfig(queries=Q, epochs=epochs, mode=mode, seed=SEED,
                    ckpt_dtype="float32")


def _entries(users, root, *, factory=True, committee_kw=None):
    out = []
    for i, u in enumerate(users):
        path = root / f"fleet_u{i}"
        path.mkdir()
        kw = (committee_kw or {}).get(i, {})
        out.append(FleetUser(
            f"u{i}", _committee(u, **kw), _data(u, f"u{i}"), str(path),
            seed=SEED,
            committee_factory=(lambda p=str(path): workspace.load_committee(
                p)) if factory else None))
    return out


def _sequential(users, root, cfg, *, pad=None, committee_kw=None):
    out = []
    for i, u in enumerate(users):
        path = root / f"seq_u{i}"
        path.mkdir()
        out.append(ALLoop(cfg, pad_pool_to=pad, device="cpu").run_user(
            _committee(u, **(committee_kw or {}).get(i, {})),
            _data(u, f"u{i}"), str(path)))
    return out


def _jsonl(path, name="metrics.jsonl"):
    with open(os.path.join(path, name)) as f:
        return [json.loads(line) for line in f]


def _state(path):
    with open(os.path.join(path, "al_state.json")) as f:
        return json.load(f)


def _pad(users):
    return max(len(set(u[1])) for u in users)


@pytest.mark.parametrize("mode", MODES)
def test_fleet_matches_sequential_and_the_jax_fleet(users, tmp_path, mode):
    cfg = _cfg(mode)
    seq = _sequential(users, tmp_path, cfg, pad=_pad(users))
    jsonl = tmp_path / "fleet_metrics.jsonl"
    sched = FleetScheduler(cfg, report=FleetReport(str(jsonl)),
                           device="cpu")
    recs = sched.run(_entries(users, tmp_path))
    jax_entries = []
    for i, u in enumerate(users):
        x, sids, labels, hc, _, _ = u
        path = tmp_path / f"jax_u{i}"
        path.mkdir()
        jax_entries.append(JaxUser(
            f"u{i}", JaxCommittee(copy.deepcopy(_jax_members(u)), []),
            JaxUserData(f"u{i}", JaxPool(x, sids), labels, hc_rows=hc),
            str(path), seed=SEED))
    jax_recs = JaxScheduler(JaxConfig(queries=Q, epochs=EPOCHS, mode=mode,
                                      seed=SEED, ckpt_dtype="float32")
                            ).run(jax_entries)
    for i, (s, r, j) in enumerate(zip(seq, recs, jax_recs)):
        assert r["error"] is None and j["error"] is None
        assert r["result"]["trajectory"] == s["trajectory"]
        assert r["result"]["trajectory"] == j["result"]["trajectory"]
        ours = _jsonl(tmp_path / f"fleet_u{i}")
        assert ours == _jsonl(tmp_path / f"seq_u{i}")
        assert _state(tmp_path / f"fleet_u{i}") == _state(
            tmp_path / f"seq_u{i}")
        theirs = [e for e in _jsonl(tmp_path / f"jax_u{i}")
                  if "event" not in e]
        assert len(theirs) == EPOCHS + 1
        for a, b in zip([e for e in ours if "event" not in e], theirs):
            assert a.get("queried") == b.get("queried")
            assert a["f1"] == b["f1"]  # tolerance 0
    summary = sched.report.write_summary(cohort=N_USERS)
    assert summary["users_done"] == N_USERS
    # how many sessions share a dispatch depends on host timing (eager
    # dispatch); one round's stacking is held by
    # test_one_round_is_one_stacked_dispatch_a_group
    assert 1.0 <= summary["mean_device_batch"] <= N_USERS
    assert 0 < summary["occupancy"] <= 1.0
    assert "dispatch_failures" not in summary and "jit" not in summary
    # host-only committees run their host blocks on the pool, timed
    assert summary["host_step_wall_s"] > 0
    labels = {"baseline", "update_eval", "checkpoint"}
    if mode not in ("hc", "rand"):  # the modes that score a probs table
        labels.add("score")
    assert {lab for lab, _, _ in sched.report.host_steps} == labels
    assert set(summary["phase_wall_s"]) >= {"select_s", "update_host_s",
                                            "evaluate_s"}
    events = _jsonl(tmp_path, "fleet_metrics.jsonl")
    assert [e["event"] for e in events].count("user_done") == N_USERS
    assert events[-1]["event"] == "fleet_summary"
    assert all(e["schema"] == 2 for e in events)


def test_eviction_resumes_at_the_pinned_pad(users, tmp_path):
    """u1's committee exhausts at its first update (an injected member
    failure under a min_members=3 floor): it is evicted, resumed from its
    workspace at the width it was admitted at, and every user ends on the
    unfaulted sequential trajectory; a rebuild on another width raises."""
    cfg = _cfg("mc")
    seq = _sequential(users, tmp_path, cfg, pad=_pad(users))
    jsonl = tmp_path / "fleet_metrics.jsonl"
    sched = FleetScheduler(cfg, report=FleetReport(str(jsonl)),
                           device="cpu")
    with faults.inject(FaultRule("member.retrain", "raise", at=1,
                                 member="sgd.victim")) as inj:
        recs = sched.run(_entries(users, tmp_path,
                                  committee_kw={1: {"victim": True}}))
    assert inj.fired
    events = _jsonl(tmp_path, "fleet_metrics.jsonl")
    assert [e["user"] for e in events if e["event"] == "evict"] == ["u1"]
    assert [e["user"] for e in events if e["event"] == "resume"] == ["u1"]
    for s, r in zip(seq, recs):
        assert r["error"] is None, r
        assert r["result"]["trajectory"] == s["trajectory"]
    assert recs[1]["resumes"] == 1 and sched.report.users_failed == 0
    with pytest.raises(ValueError, match="pinned pool pad drifted"):
        UserSession(cfg, workspace.load_committee(str(tmp_path / "fleet_u1")),
                    _data(users[1], "u1"), str(tmp_path / "fleet_u1"),
                    pad_pool_to=64, pin_pad=_pad(users) + 2, device="cpu")


def test_eviction_without_factory_fails_only_that_user(users, tmp_path):
    cfg = _cfg("mc", epochs=2)
    seq = _sequential(users, tmp_path, cfg, pad=_pad(users))
    with faults.inject(FaultRule("member.retrain", "raise", at=1,
                                 member="sgd.victim")) as inj:
        recs = FleetScheduler(cfg, device="cpu").run(_entries(
            users, tmp_path, factory=False,
            committee_kw={0: {"victim": True}}))
    assert inj.fired
    assert recs[0]["error"] is not None and recs[0]["result"] is None
    assert "CommitteeExhausted" in recs[0]["error"]
    for s, r in zip(seq[1:], recs[1:]):
        assert r["error"] is None
        assert r["result"]["trajectory"] == s["trajectory"]


class CountingGuard:
    """Requests preemption after ``after`` checks."""

    def __init__(self, after):
        self.checks, self.after = 0, after

    @property
    def requested(self):
        self.checks += 1
        return self.checks > self.after


def test_preemption_leaves_every_workspace_resumable(users, tmp_path):
    cfg = _cfg("mc")
    seq = _sequential(users, tmp_path, cfg, pad=_pad(users))
    entries = _entries(users, tmp_path)
    with pytest.raises(Preempted):
        FleetScheduler(cfg, preemption=CountingGuard(2),
                       device="cpu").run(entries)
    for e in entries:  # each workspace committed and loadable
        assert al_state.ALState.load(e.user_path) is not None
    again = [FleetUser(e.user_id, workspace.load_committee(e.user_path),
                       e.data, e.user_path, seed=SEED) for e in entries]
    recs = FleetScheduler(cfg, device="cpu").run(again)
    for s, r in zip(seq, recs):
        assert r["error"] is None
        assert r["result"]["trajectory"] == s["trajectory"]


def test_occupancy_excludes_finished_and_evicted(users, tmp_path):
    """A user failed in its first iteration stops counting at once: no
    later dispatch grades itself against its dead slot."""
    cfg = _cfg("mc", epochs=2)
    sched = FleetScheduler(cfg, device="cpu")
    with faults.inject(FaultRule("member.retrain", "raise", at=1,
                                 member="sgd.victim")) as inj:
        recs = sched.run(_entries(users, tmp_path, factory=False,
                                  committee_kw={0: {"victim": True}}))
    assert inj.fired and recs[0]["error"] is not None
    ds = sched.report.dispatches
    assert all(d["active"] <= N_USERS for d in ds)
    assert ds[-1]["active"] <= 2 and ds[-1]["batch"] <= ds[-1]["active"]
    assert 0 < sched.report.occupancy <= 1.0


def test_abort_joins_checkpointers_before_the_pool_shuts_down(users,
                                                             tmp_path):
    """On the abort path (a preemption), every other live generator is
    closed, joining its checkpointer mid-commit (slowed by a delay fault),
    before the shared checkpoint pool shuts down."""
    cfg = _cfg("mc", epochs=2)
    sched = FleetScheduler(cfg, preemption=CountingGuard(1), device="cpu")
    with faults.inject(FaultRule("checkpoint.write", "delay", at=1,
                                 times=16, delay_s=0.05)):
        with pytest.raises(Preempted):
            sched.run(_entries(users, tmp_path))
    assert sched._ckpt_pool._shutdown
    for i in range(N_USERS):
        assert al_state.ALState.load(str(tmp_path / f"fleet_u{i}")) \
            is not None


def test_shared_executor_keeps_each_sessions_order():
    """Per-session order holds on a shared pool, and ``close`` leaves the
    shared pool to its owner."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=4)
    try:
        log, gate = [], threading.Event()
        a = AsyncCheckpointer(executor=pool)
        b = AsyncCheckpointer(executor=pool)
        a.submit(lambda: (gate.wait(2), log.append("a1")))
        b.submit(lambda: log.append("b1"))  # runs while a1 blocks
        b.wait()
        assert log == ["b1"]
        gate.set()
        a.submit(lambda: log.append("a2"))  # joins a1 first
        a.wait()
        assert log == ["b1", "a1", "a2"]
        a.close()
        with pytest.raises(RuntimeError, match="closed"):
            a.submit(lambda: None)
        b.submit(lambda: log.append("b2"))  # the pool outlives a's close
        b.close()
        assert log[-1] == "b2"
    finally:
        pool.shutdown(wait=True)


def test_failed_stacked_dispatch_serves_each_user(users, tmp_path):
    """A stacked dispatch that fails is recorded and its group served one
    user at a time: the results are unchanged.  The cohort is stepped to
    its first select and that round is dispatched as one group, so the
    fault lands on a stacked dispatch whatever the host timing; the rest
    of the run is pumped as usual."""
    from consensus_entropy_tpu_torch.fleet.session import (
        DeviceStep,
        HostStep,
        ScoreStep,
    )

    cfg = _cfg("mix", epochs=2)
    seq = _sequential(users, tmp_path, cfg, pad=_pad(users))
    entries = _entries(users, tmp_path)
    sched = FleetScheduler(cfg, device="cpu")
    sched.open(N_USERS)
    try:
        states = [sched.admit(e, pad=_pad(users)) for e in entries]
        sched._ready.clear()
        round_ = []
        for st in states:
            sched._live[st] = None
            step = sched._advance(st)
            while isinstance(step, (HostStep, DeviceStep)):
                step = sched._advance(st, step.fn() if isinstance(
                    step, HostStep) else step.single())
            assert isinstance(step, ScoreStep)
            round_.append((st, step))
        with faults.inject(FaultRule("serve.dispatch", "raise",
                                     at=1)) as inj:
            served = sched._dispatch_scores(round_)
        assert [f["batch"] for f in inj.fired] == [N_USERS]
        for st, res in served:
            sched._ready.append((st, res, None))
        while sched.pump():
            pass
    finally:
        sched.close()
    recs = [sched.results[id(e)] for e in entries]
    summary = sched.report.summary(cohort=N_USERS)
    assert summary["dispatch_failures"] == 1
    assert [d["batch"] for d in sched.report.dispatches[:N_USERS]] \
        == [1] * N_USERS
    for s, r in zip(seq, recs):
        assert r["result"]["trajectory"] == s["trajectory"]


def test_gbdt_member_is_its_sequential_fit_under_three_workers(users,
                                                               tmp_path):
    """Three GBDT fits at once (one per host worker, each with its share
    of the OpenMP cores) build the trees of the sequential fits, bit for
    bit."""
    cfg = _cfg("mc", epochs=2)
    kw = {i: {"gbdt": True} for i in range(N_USERS)}
    seq = _sequential(users, tmp_path, cfg, pad=_pad(users),
                      committee_kw=kw)
    recs = FleetScheduler(cfg, host_workers=3, device="cpu").run(
        _entries(users, tmp_path, committee_kw=kw))
    for i, (s, r) in enumerate(zip(seq, recs)):
        assert r["result"]["trajectory"] == s["trajectory"]
        name = "classifier_xgb.xgb.it_0.npz"
        with np.load(tmp_path / f"fleet_u{i}" / name) as a, \
                np.load(tmp_path / f"seq_u{i}" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for f in a.files:
                np.testing.assert_array_equal(a[f], b[f])


def test_open_admit_pump_over_two_buckets(users, tmp_path):
    """The lifecycle a serving loop holds open: users admitted at two
    pool widths, pumped to the end, each width its own dispatch group
    (width-guarded scorers, per-bucket occupancy), every trajectory its
    sequential run's at the same width."""
    cfg = _cfg("mix", epochs=2)
    pads = (32, 32, 64)
    seq = []
    for i, (u, pad) in enumerate(zip(users, pads)):
        (tmp_path / f"seq_u{i}").mkdir()
        seq.append(ALLoop(cfg, pad_pool_to=pad, device="cpu").run_user(
            _committee(u), _data(u, f"u{i}"), str(tmp_path / f"seq_u{i}")))
    entries = _entries(users, tmp_path)
    sched = FleetScheduler(cfg, scoring_by_width=True, device="cpu")
    sched.open(len(entries))
    try:
        for e, pad in zip(entries, pads):
            sched.admit(e, pad=pad)
        assert sched.n_live == N_USERS and sched.has_work
        while sched.pump():
            pass
        assert not sched.has_work and sched.n_live == 0
    finally:
        sched.close()
    for e, s in zip(entries, seq):
        assert sched.results[id(e)]["result"]["trajectory"] == \
            s["trajectory"]
    per = sched.report.summary(cohort=N_USERS)["per_bucket"]
    assert sorted(per) == [32, 64]
    # two users share width 32; the one at 64 never stacks with them
    assert 1.0 <= per[32]["mean_batch"] <= 2.0
    assert per[64]["mean_batch"] == 1.0
    assert all(0 < b["occupancy"] <= 1.0 for b in per.values())


def test_depth_dial_caps_live_committees(users, tmp_path):
    cfg = _cfg("mc")
    sched = FleetScheduler(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown depth"):
        sched.set_depth("deep")
    sched.set_depth("cheap")
    entries = _entries(users[:1], tmp_path)
    committee = entries[0].committee
    sched.open(1)
    try:
        sched.admit(entries[0], pad=_pad(users))
        assert committee.depth_cap == 1
        assert len(committee.active_host_members) == 1
        sched.pump()  # the session now holds a slot
        sched.set_depth("full")
        assert committee.depth_cap is None
        assert len(committee.active_host_members) == 2
        sched.abort()
    finally:
        sched.close()


def test_one_round_is_one_stacked_dispatch_a_group(users, tmp_path):
    """The dispatch round without host timing: three acquirers' fused mc
    steps at one width form ONE stacked dispatch whose rows are their own
    single calls (tolerance 0), a fourth at another width is served by
    its own call, and the uploads each acquirer staged are graded."""
    import types

    from consensus_entropy_tpu_torch.al.acquisition import Acquirer
    from consensus_entropy_tpu_torch.fleet.session import ScoreStep

    rng = np.random.default_rng(3)
    songs = [f"s{i}" for i in range(24)]
    sched = FleetScheduler(_cfg("mc"), device="cpu")
    sched.open(4)
    try:
        work = []
        for i, pad in enumerate((32, 32, 32, 64)):
            probs = rng.uniform(0.01, 1, (2, 24, 4)).astype(np.float32)
            fleet_acq, own_acq = (Acquirer(songs, None, queries=Q,
                                           mode="mc", pad_to=pad,
                                           device="cpu")
                                  for _ in range(2))
            fn_key, inputs = fleet_acq.scoring_inputs(probs)
            state = types.SimpleNamespace(
                n_pad=fleet_acq.n_pad,
                entry=types.SimpleNamespace(user_id=f"u{i}"))
            step = ScoreStep(types.SimpleNamespace(acq=fleet_acq), fn_key,
                             inputs)
            own = own_acq.run_scoring(*own_acq.scoring_inputs(probs))
            work.append((state, step, own))
        rows = dict((id(st), res) for st, res in sched._dispatch_scores(
            [(st, step) for st, step, _ in work]))
        for st, step, own in work:
            res = rows[id(st)]
            for field, got, ref in zip(res._fields, res, own):
                assert (got is None and ref is None) or torch.equal(
                    got, ref), field
            assert res.pool_mask is step.inputs[1]  # the session's twin
    finally:
        sched.close()
    ds = sorted(sched.report.dispatches, key=lambda d: -d["batch"])
    assert [(d["fn"], d["batch"]) for d in ds] == [("mc_fused", 3),
                                                   ("mc_fused", 1)]
    # each acquirer uploaded its probs (at the 32-wide staging width) and
    # its mask twin (first use)
    per_user = 2 * 32 * 4 * 4 + 32
    assert ds[0]["h2d_bytes"] == 3 * per_user and ds[0]["h2d_ops"] == 6
