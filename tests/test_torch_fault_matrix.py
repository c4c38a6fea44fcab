"""The JAX package's kill matrix against the port, on the CPU.

- **Per-session rows** (``tests/test_resilience.py:91-98``): each of the 6
  boundaries in every mode where it fires, 26 rows.  The port's run of the
  JAX matrix's user (``_make_user``'s draws, GaussianNB and SGD fitted on
  its frames: ``cli/fault_matrix.py``'s ``session_user`` and
  ``session_committee``) is killed at the boundary's hit, resumed through
  ``workspace.load_committee``, and ends on the port's unfaulted run,
  whose trajectory and queried songs equal the JAX package's unfaulted run
  (tolerance 0: host members).
- **Storage rows** (``tests/test_durability.py:155-236``): a journal
  append torn by ``io.write.short`` and a kill replays to the state before
  it, ``io.write.enospc`` / ``io.write.eio`` raise before any byte, and a
  dropped ``io.fsync`` is silent and surfaced, in both packages alike.
- **Serve rows** (``tests/test_serve_faults.py:331-372``): an in-process
  ``FleetServer`` of the JAX drills' three users killed at each
  ``(point, at)`` and in each mode's restart row, restarted from its
  journal: every user ends on its sequential run, which equals the JAX
  package's, and the journal replays in the JAX package's
  ``AdmissionJournal`` to the port's state.

The qbdc rows are in ``test_torch_fault_matrix_qbdc.py``, the fabric's
decision points in ``test_torch_fabric_faults.py``."""

import copy
import errno
import os
import threading

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.al import state as jax_state
from consensus_entropy_tpu.al.loop import ALLoop as JaxLoop
from consensus_entropy_tpu.fleet import FleetReport as JaxReport
from consensus_entropy_tpu.fleet import FleetScheduler as JaxScheduler
from consensus_entropy_tpu.fleet import FleetUser as JaxUser
from consensus_entropy_tpu.models.committee import Committee as JaxCommittee
from consensus_entropy_tpu.resilience import faults as jax_faults
from consensus_entropy_tpu.resilience import io as jax_io
from consensus_entropy_tpu.serve import AdmissionJournal as JaxJournal
from consensus_entropy_tpu.serve import FleetServer as JaxServer
from consensus_entropy_tpu.serve import ServeConfig as JaxServeConfig
from consensus_entropy_tpu_torch import convert
from consensus_entropy_tpu_torch.al import state as al_state
from consensus_entropy_tpu_torch.al import workspace
from consensus_entropy_tpu_torch.al.loop import ALLoop, UserData
from consensus_entropy_tpu_torch.cli import fault_matrix as fm
from consensus_entropy_tpu_torch.config import ALConfig
from consensus_entropy_tpu_torch.fleet import (
    FleetReport,
    FleetScheduler,
    FleetUser,
)
from consensus_entropy_tpu_torch.models.committee import Committee, FramePool
from consensus_entropy_tpu_torch.obs import export
from consensus_entropy_tpu_torch.resilience import faults
from consensus_entropy_tpu_torch.resilience import io as dio
from consensus_entropy_tpu_torch.resilience.faults import (
    FaultRule,
    InjectedKill,
)
from consensus_entropy_tpu_torch.serve import (
    AdmissionJournal,
    FleetServer,
    ServeConfig,
)
from tests import test_fleet as jax_fleet
from tests import test_resilience as jax_res

torch.set_num_threads(1)

pytestmark = pytest.mark.faults

ROWS = [pytest.param(mode, point, at, id=f"{mode}-{point}")
        for point, (at, modes) in sorted(fm.BOUNDARIES.items())
        for mode in modes]


def test_the_matrix_is_the_jax_packages():
    assert fm.BOUNDARIES == jax_res.BOUNDARIES
    assert len(ROWS) == 26


# -- per-session rows ------------------------------------------------------


class _Baselines:
    """Each mode's unfaulted runs, made once a module: the JAX package's
    and the port's, held equal on first use, with each package's fault
    point hits."""

    def __init__(self, root):
        self.root = root
        self.runs = {}

    def __call__(self, mode):
        if mode not in self.runs:
            jax_dir, port_dir = (self.root / f"{p}_{mode}"
                                 for p in ("jax", "port"))
            jax_dir.mkdir()
            data = jax_res._make_user(np.random.default_rng(
                fm.SESSION["user_seed"]))
            with jax_faults.inject() as theirs:
                jax_out = jax_res._run(data, jax_dir, mode=mode)
            with faults.inject() as ours:
                out = fm.session_run(fm.session_user(), str(port_dir), mode,
                                     "cpu")
            assert out["trajectory"] == jax_out["trajectory"]  # tol 0
            queried = al_state.ALState.load(str(port_dir)).queried
            assert queried == jax_state.ALState.load(str(jax_dir)).queried
            self.runs[mode] = (out, queried, ours.hits, theirs.hits)
        return self.runs[mode]


@pytest.fixture(scope="module")
def baselines(tmp_path_factory):
    return _Baselines(tmp_path_factory.mktemp("baselines"))


def test_the_port_draws_the_jax_matrix_user():
    ours = fm.session_user()
    theirs = jax_res._make_user(np.random.default_rng(
        fm.SESSION["user_seed"]))
    np.testing.assert_array_equal(ours.pool.X, theirs.pool.X)
    assert list(ours.pool.song_ids) == list(theirs.pool.song_ids)
    assert ours.labels == theirs.labels
    np.testing.assert_array_equal(ours.hc_rows, theirs.hc_rows)


@pytest.mark.parametrize("mode,point,at", ROWS)
def test_kill_at_every_boundary_resumes_to_the_jax_run(baselines, tmp_path,
                                                       mode, point, at):
    ref, queried, _, _ = baselines(mode)
    data = fm.session_user()
    path = str(tmp_path / "faulted")
    out = fm.kill_and_resume(
        lambda p, committee=None: fm.session_run(data, p, mode, "cpu",
                                                 committee=committee),
        workspace.load_committee, point, at, path)
    assert [f["point"] for f in out["fired"]] == [point]
    assert out["result"]["trajectory"] == ref["trajectory"]
    assert al_state.ALState.load(path).queried == queried


@pytest.mark.parametrize("mode", ["mc", "hc", "mix", "rand", "wmc"])
def test_an_unfaulted_run_hits_each_point_as_jax(baselines, mode):
    """Each point is hit as often in the port as in the JAX package, so a
    row's hit number means the same boundary in both (members scored on
    the host; ``test_torch_fault_coverage.py`` holds them on the
    device)."""
    _, _, hits, jax_hits = baselines(mode)
    assert hits == jax_hits
    assert ("member.predict" in hits) == (mode in ("mc", "mix", "wmc"))


# -- storage rows ------------------------------------------------------------


def _journal_pair(tmp_path, name):
    """The same records appended by both packages' journals."""
    out = []
    for pkg, journal in (("jax", JaxJournal), ("port", AdmissionJournal)):
        path = str(tmp_path / f"{pkg}_{name}.jsonl")
        j = journal(path)
        j.append("enqueue", "a")
        j.append("admit", "a")
        out.append((path, j))
    return out


def _replays(path):
    """The journal at ``path`` replayed by both packages."""
    theirs, ours = JaxJournal(path), AdmissionJournal(path)
    try:
        assert theirs.state.to_dict() == ours.state.to_dict()
        return ours.state.to_dict()
    finally:
        theirs.close()
        ours.close()


def test_short_write_then_kill_replays_to_the_state_before(tmp_path):
    states = []
    for (path, j), (pkg_faults, pkg_io, journal) in zip(
            _journal_pair(tmp_path, "short"),
            ((jax_faults, jax_io, JaxJournal),
             (faults, dio, AdmissionJournal))):
        pre = j.state.to_dict()
        size = os.path.getsize(path)
        with pkg_faults.inject(pkg_faults.FaultRule("io.write.short",
                                                    "kill")) as inj:
            with pytest.raises(pkg_faults.InjectedKill):
                j.append("finish", "a")  # half a line lands, then death
            assert inj.fired
        j.close()
        assert os.path.getsize(path) > size
        j2 = journal(path)
        assert j2.state.to_dict() == pre  # the torn append never happened
        j2.append("finish", "a")  # the retried transition lands
        assert os.path.exists(pkg_io.quarantine_path(path))
        j2.close()
        states.append(_replays(path))
    assert states[0] == states[1]
    assert AdmissionJournal(str(tmp_path / "port_short.jsonl")) \
        .state.finished == {"a"}


@pytest.mark.parametrize("point,eno", [("io.write.enospc", errno.ENOSPC),
                                       ("io.write.eio", errno.EIO)])
def test_write_errors_raise_before_any_byte(tmp_path, point, eno):
    states = []
    for (path, j), pkg_faults in zip(_journal_pair(tmp_path, point),
                                     (jax_faults, faults)):
        pre, size = j.state.to_dict(), os.path.getsize(path)
        with pkg_faults.inject(pkg_faults.FaultRule(point, "raise")) as inj:
            with pytest.raises(OSError) as e:
                j.append("finish", "a")
            assert e.value.errno == eno and inj.fired
        j.close()
        assert os.path.getsize(path) == size  # nothing reached the file
        states.append(_replays(path))
        assert states[-1] == pre
    assert states[0] == states[1]


def test_a_dropped_fsync_is_silent_and_surfaced(tmp_path):
    """``tests/test_durability.py:176-189`` on a journal append: the lying
    disk drops the barrier without an error, the record lands, and the
    drop reaches the io listeners, in both packages alike."""
    states = []
    for (path, j), pkg_faults, pkg_io in zip(
            _journal_pair(tmp_path, "fsync"), (jax_faults, faults),
            (jax_io, dio)):
        seen = []

        def listener(kind, path, seen=seen):
            seen.append(kind)

        pkg_io.add_listener(listener)
        try:
            with pkg_faults.inject(pkg_faults.FaultRule("io.fsync",
                                                        "raise")) as inj:
                j.append("finish", "a")  # no exception
            assert inj.fired
        finally:
            pkg_io.remove_listener(listener)
        j.close()
        assert "io.fsync" in seen
        states.append(_replays(path))
        assert AdmissionJournal(path).state.finished == {"a"}
    assert states[0] == states[1]


# -- serve rows --------------------------------------------------------------

SERVE_USERS = [(100 + i, f"u{i}", 30) for i in range(3)]


def _serve_cfg(mode):
    # the JAX drills' tests/test_fleet.py::_cfg
    return ALConfig(queries=4, epochs=2, mode=mode, seed=7,
                    ckpt_dtype="float32")


def _serve_user(seed, uid, n):
    """The JAX drills' user (``tests/test_fleet.py::_user_data``) and its
    committee's JAX members, fitted on its frames."""
    data = jax_fleet._user_data(seed, uid, n_songs=n)
    return data, jax_fleet._committee(data).host_members


def _port_data(jdata):
    return UserData(jdata.user_id, FramePool(
        jdata.pool.X, np.repeat(np.asarray(jdata.pool.song_ids),
                                jdata.pool.counts)),
        jdata.labels, hc_rows=jdata.hc_rows)


class _Sequential:
    """Each mode's sequential runs of the three users, in both packages,
    held equal on first use."""

    def __init__(self, root):
        self.root = root
        self.runs = {}

    def __call__(self, mode):
        if mode not in self.runs:
            jcfg = jax_fleet._cfg(mode=mode, epochs=2)
            out = {}
            for seed, uid, n in SERVE_USERS:
                jdata, members = _serve_user(seed, uid, n)
                jp, pp = (self.root / f"{p}_{mode}_{uid}"
                          for p in ("jax", "port"))
                jp.mkdir()
                pp.mkdir()
                theirs = JaxLoop(jcfg).run_user(
                    jax_fleet._committee(jdata), jdata, str(jp))
                ours = ALLoop(_serve_cfg(mode), device="cpu").run_user(
                    Committee(convert.host_members_from_jax(
                        copy.deepcopy(members)), device="cpu"),
                    _port_data(jdata), str(pp))
                assert ours["trajectory"] == theirs["trajectory"]
                assert ours["final_mean_f1"] == theirs["final_mean_f1"]
                out[uid] = ours
            self.runs[mode] = out
        return self.runs[mode]


@pytest.fixture(scope="module")
def sequential(tmp_path_factory):
    return _Sequential(tmp_path_factory.mktemp("sequential"))


def _entries(root):
    """Serve entries over ``serve_<uid>`` workspaces; a workspace a killed
    run left resumes from its own files, as the CLI's restart does."""
    out = []
    for seed, uid, n in SERVE_USERS:
        jdata, members = _serve_user(seed, uid, n)
        path = root / f"serve_{uid}"
        path.mkdir(exist_ok=True)
        if (path / "al_state.json").exists():
            committee = workspace.load_committee(str(path))
        else:
            committee = Committee(convert.host_members_from_jax(members),
                                  device="cpu")
        out.append(FleetUser(
            uid, committee, _port_data(jdata), str(path), seed=7,
            committee_factory=lambda p=str(path): workspace.load_committee(
                p)))
    return out


def _server(cfg, journal):
    sched = FleetScheduler(cfg, report=FleetReport(), scoring_by_width=True,
                           device="cpu")
    return FleetServer(sched, ServeConfig(target_live=2), journal=journal)


def _restart_drill(root, mode, rule):
    """The JAX drills' ``_restart_drill``: kill the server at ``rule``,
    restart it from the journal; ``{user: last result}`` over both runs."""
    cfg = _serve_cfg(mode)
    jpath = str(root / "serve_journal.jsonl")
    done = {}

    def on_result(rec):
        done[rec["user"]] = rec

    with faults.inject(rule) as inj:
        journal = AdmissionJournal(jpath)
        with pytest.raises(InjectedKill):
            _server(cfg, journal).serve(iter(_entries(root)),
                                        on_result=on_result)
        assert inj.fired, f"{rule.point} never fired"
        journal.close()
    journal = AdmissionJournal(jpath)
    assert journal.recovered
    order = journal.state.recovery_order([uid for _, uid, _ in SERVE_USERS])
    emap = {e.user_id: e for e in _entries(root)}
    _server(cfg, journal).serve(iter(emap[u] for u in order),
                                on_result=on_result)
    journal.close()
    return done, jpath


def _served_as_sequential(done, seq, jpath):
    assert sorted(done) == [uid for _, uid, _ in SERVE_USERS]
    for uid, rec in done.items():
        assert rec["error"] is None
        assert rec["result"]["trajectory"] == seq[uid]["trajectory"]
        assert rec["result"]["final_mean_f1"] == seq[uid]["final_mean_f1"]
    _replays(jpath)  # the JAX package's replay of the port's WAL
    st = AdmissionJournal(jpath).state
    assert st.finished == set(done) and not st.pending


@pytest.mark.parametrize("point,at", [
    ("serve.admit", 2),           # between queue pop and durable admit
    ("serve.journal.append", 4),  # mid-admission (the admit record)
    ("serve.journal.append", 6),  # the first finish record
    ("serve.collect", 1),         # engine done, finish not yet journaled
    ("serve.dispatch", 2),        # mid device dispatch
], ids=lambda v: str(v))
def test_serve_kill_matrix_restart_loses_no_user(sequential, tmp_path,
                                                 point, at):
    done, jpath = _restart_drill(tmp_path, "mc",
                                 FaultRule(point, "kill", at=at))
    _served_as_sequential(done, sequential("mc"), jpath)


def _evict_while_admitting(server):
    """Serve ``server``'s first entry with a disconnect's evict sent from
    another thread the moment the user leaves the queue (before it is in
    flight); returns the evict's verdict."""
    pop, verdicts, threads = server.queue.pop, [], []

    def racing_pop(**kw):
        item = pop(**kw)
        if item is not None and not threads:
            threads.append(threading.Thread(target=lambda: verdicts.append(
                server.evict(item[0].user_id))))
            threads[0].start()
            threads[0].join(0.2)  # the port's evict waits for the admission
        return item

    server.queue.pop = racing_pop
    return server, threads, verdicts


def test_an_evict_racing_an_admission_is_deferred(tmp_path):
    """The user is in flight to a worker from its queue pop: the evict
    waits for the admission, is deferred (``None``) and acks at the
    release.  The JAX package refuses it in that window (``False``), and
    its coordinator, reading the refusal as "never held", routes the
    disconnected user to a second host, which runs it again (ROADMAP
    C20)."""
    seed, uid, n = SERVE_USERS[0]
    jdata, members = _serve_user(seed, uid, n)
    (tmp_path / "jax").mkdir()
    jax_journal = JaxJournal(str(tmp_path / "jax_journal.jsonl"))
    theirs, threads, jax_verdicts = _evict_while_admitting(JaxServer(
        JaxScheduler(jax_fleet._cfg(mode="mc", epochs=2),
                     report=JaxReport(), scoring_by_width=True),
        JaxServeConfig(target_live=2), journal=jax_journal))
    theirs.serve(iter([JaxUser(uid, JaxCommittee(members, []), jdata,
                               str(tmp_path / "jax"), seed=7)]))
    threads[0].join()
    jax_journal.close()
    jpath = str(tmp_path / "journal.jsonl")
    journal = AdmissionJournal(jpath)
    ours, threads, verdicts = _evict_while_admitting(
        _server(_serve_cfg("mc"), journal))
    ours.serve(iter(_entries(tmp_path)[:1]))
    threads[0].join()
    journal.close()
    assert jax_verdicts == [False]
    assert verdicts == [None]
    # the deferred ack: the session released at a step boundary
    assert [(r["user"], r["ok"]) for r in export.read_jsonl_tolerant(jpath)
            if r.get("event") == "drop"] == [(uid, True)]


@pytest.mark.parametrize("mode", ["mc", "hc", "mix", "rand"])
def test_serve_restart_matrix_all_modes(sequential, tmp_path, mode):
    done, jpath = _restart_drill(
        tmp_path, mode, FaultRule("serve.journal.append", "kill", at=6))
    _served_as_sequential(done, sequential(mode), jpath)
