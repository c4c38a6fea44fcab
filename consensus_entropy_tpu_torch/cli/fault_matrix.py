"""``fault_matrix``: the JAX package's fault matrix and its CI gate legs,
against the port.

Counterpart of ``scripts/fault_matrix.sh`` and the gates it runs
(``elastic_check.sh``, ``remedy_check.sh``, ``gray_check.sh``,
``soak_check.sh``, ``fsck_check.sh``, ``obs_check.sh``, ``slo_check.sh``
and ``mesh_check.sh`` leg 2).  Each ``--leg`` prints one JSON line; the
command exits 1 if any leg failed.  It runs on ``cuda`` unless ``--device
cpu`` is passed, and raises without CUDA.

In-process legs (the per-session kill matrix at the device fault points):

- ``session``: an AL run killed at ``pool.score``, ``member.predict``,
  ``state.save`` and ``checkpoint.write`` (the JAX matrix's hits,
  ``tests/test_resilience.py:91-98``), resumed through
  ``workspace.load_committee``; its trajectory and queried songs equal
  the unfaulted run's.  ``member.predict`` fires only for members scored
  on the host (in both packages), so that row scores on the host and the
  others with ``--device-members``.
- ``qbdc``: the same at ``acquire.qbdc.masks``, ``pool.score``,
  ``state.save`` and ``checkpoint.write`` for a committee of GaussianNB,
  SGD and two narrow vgg members (queried songs equal, F1s within the CNN
  members' gate).

Real-worker legs: the port's ``FabricCoordinator`` in this process over
the production worker (``amg_test --fabric-worker``, ``--device`` passed
through), on the seeded host-member tree of ``data/synth.py`` (a GaussianNB
and an SGD member pre-trained by ``deam_classifier``), each user run
``-q 4 -e 2 -m mc`` as the JAX gates' ``make_cfg("mc", epochs=2)``.
Faults reach the workers through ``CETPU_FAULTS``; the coordinator's own
kills are in-process ``faults.inject`` rules, as in the JAX scripts.

- ``elastic`` (``elastic_check.sh`` leg 1): 2 elastic hosts (max 3), h0
  SIGKILLed at its first admission; the autoscaler's ``spawn`` and a fresh
  host id in the replayed fleet shape; every surviving host ends on the
  same merged planner edges, the journal's.
- ``drain`` (``elastic_check.sh`` leg 2): 3 elastic hosts (at least 2),
  every score slowed, the low-water mark forced once each host holds a
  user in flight, so the fabric scales down mid-run; the coordinator
  killed at ``fabric.drain``, ``fabric.migrate.fence`` and
  ``fabric.migrate.commit`` and rerun, each rerun ending on 2 hosts.
- ``remedy`` (``remedy_check.sh`` legs 1-3): 3 hosts, h0 slowed by
  ``pool.score:delay``: a rebalance without retirement; a fence deadline
  demoted to evict+resume (h0's checkpoint commits also held, so its
  fence cannot be acked within a poll); the coordinator killed at
  ``fabric.remedy`` and rerun.
- ``gray`` (``gray_check.sh`` legs 1-2): 3 hosts, h0 with
  ``serve.dispatch:stall``: the ladder to ``gray_drain`` with h0 never
  retired; the coordinator killed at ``fabric.gray`` and rerun, the users
  h0 held finishing elsewhere.
- ``soak`` (``soak_check.sh`` legs 1-2): a compressed ``workload`` trace
  through ``TraceDriver(FabricTarget(coord))`` on 2 keep-open hosts with
  the burn-rate hold armed: at least one ``slo_headroom`` alert fired and
  graded, one journaled hold, zero loss; then the coordinator killed at
  ``fabric.remedy`` mid-soak and the rerun finishing every trace user
  exactly once.
- ``skew`` (``soak_check.sh`` leg 3): the soak fabric under the first
  ``skew`` trace whose drawn pools hold a strict hot-size majority and
  still draw the cold size: zero loss, valid streams, percentile rows for
  both classes.  The drawn sizes are the users' enqueue-time pools (a
  worker runs each tree user on the pool its annotations fix).
- ``fsck`` (``fsck_check.sh`` legs 1 and 2a): a full 2-host run; one byte
  of a mid-file framed ``enqueue`` record flipped halts replay with
  ``JournalCorruption``; ``cli.fsck`` exits 1, ``--repair`` quarantines
  the line and sweeps a planted ``.tmp``, a second check exits 0 and the
  journal replays every disposition; a second coordinator incarnation
  claims epoch 2 and re-runs nothing.  (Leg 2b, the split-brain drill,
  is a fake-worker test: ``tests/test_torch_elastic.py``.)
- ``obs`` (``obs_check.sh`` legs 1-2): a traced serve cohort (valid
  metrics, orphan-free spans, the Chrome export, ``report --validate
  --out``), then a traced 3-host drain and migrate with the
  introspection plane on: mid-run status snapshots validate, a burn-rate
  ``alert`` fires, the control-plane lane's drain, fence and migrate
  spans are flow-linked into the users' traces, ``top --once`` renders.
- ``slo`` (``slo_check.sh``): a planner-enabled 2-class serve cohort whose
  metrics validate, with per-class histograms and the planner's events,
  and whose replayed journal restores the live bucket edges.
- ``mesh`` (``mesh_check.sh`` leg 2): ``FabricConfig(hosts=2,
  mesh_devices=(4, 1))``; h0's worker serves through a 4-way pool mesh,
  spelled ``--mesh cuda:0,cuda:0,cuda:0,cuda:0`` (``cpu`` entries under
  ``--device cpu``) as ``amg_test --hosts --mesh-devices`` spawns it, and
  is SIGKILLed at its first admission; one revocation, the heartbeats'
  widths 4 and 1, every user finished on h1.

The serve cohorts of ``slo`` and ``obs`` run the tree's users in this
process through ``FleetServer`` (the CLI's serve path, with the gates'
``ServeConfig``), each user's state held to its sequential run's.

Every real-worker leg also checks what its JAX gate checks: the journal
and every per-host event WAL validate; each user has exactly one
``finish`` that ran it (a worker journals ``skipped`` for a user whose
workspace was already done) across every host's WAL; each user's
``al_state.json`` equals its sequential run's (``amg_test`` without
``--serve``).  Each worker start is timed from its spawn to its first
lease; the elastic leg also times the kill to the replacement's first
lease, the mesh leg the kill to the journaled revoke.

    python -m consensus_entropy_tpu_torch.cli.fault_matrix --leg elastic
    python -m consensus_entropy_tpu_torch.cli.fault_matrix --leg all \
        --device cpu --root DIR
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import glob
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from consensus_entropy_tpu_torch.cli.common import add_device_arg

# -- the per-session kill matrix -------------------------------------------

#: the JAX kill matrix's boundaries (``tests/test_resilience.py:91-98``):
#: point -> (the hit that lands mid-run for the 2-member host committee,
#: the modes where the point fires)
BOUNDARIES = {
    "checkpoint.write": (3, ("mc", "hc", "mix", "rand", "wmc")),
    "member.retrain": (3, ("mc", "hc", "mix", "rand", "wmc")),
    "member.predict": (3, ("mc", "mix", "wmc")),
    "pool.score": (2, ("mc", "mix", "wmc")),
    "state.save": (2, ("mc", "hc", "mix", "rand", "wmc")),
    "multihost.sync": (1, ("mc", "hc", "mix", "rand", "wmc")),
}
#: the ``session`` leg's rows: (point, members scored on the device)
DEVICE_ROWS = (("pool.score", True), ("member.predict", False),
               ("state.save", True), ("checkpoint.write", True))
#: the qbdc rows (``tests/test_resilience.py:146-150``'s points): each
#: hit lands mid-run for 2 host + 2 vgg members over QBDC["epochs"]
#: iterations (the masks and the score fire once a scored iteration, the
#: state once a commit, a member file 4 times a commit, the host members'
#: first and the vgg members' in the deferred write: hit 7 is the second
#: commit's first vgg file)
QBDC_BOUNDARIES = (("acquire.qbdc.masks", 2), ("pool.score", 2),
                   ("state.save", 2), ("checkpoint.write", 7))
SESSION = {"queries": 3, "epochs": 4, "seed": 11, "user_seed": 1987}
#: the narrow vgg geometry of the CNN tests
QBDC_CNN = {"n_channels": 4, "n_mels": 32, "n_layers": 5,
            "input_length": 8192}
QBDC = {"queries": 3, "epochs": 2, "seed": 11, "qbdc_k": 4,
        "retrain_epochs": 1, "user_seed": 1987, "batch_size": 2}
#: the CNN members' gate (PERF.md section 2)
CNN_TOL = {"rtol": 1e-4, "atol": 1e-5}


def session_user(seed: int = SESSION["user_seed"], n_songs: int = 30,
                 frames_per_song: int = 3, n_feat: int = 8):
    """The JAX matrix's ``_make_user`` draws (``tests/test_resilience.py:
    53-66``) as the port's ``UserData``."""
    from consensus_entropy_tpu_torch.al.loop import UserData
    from consensus_entropy_tpu_torch.models.committee import FramePool

    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4, n_feat)) * 3.0
    labels, X, frame_song = {}, [], []
    for s in range(n_songs):
        c = int(rng.integers(0, 4))
        sid = f"song{s:03d}"
        labels[sid] = c
        X.append(centers[c] + rng.standard_normal((frames_per_song,
                                                   n_feat)))
        frame_song += [sid] * frames_per_song
    pool = FramePool(np.concatenate(X).astype(np.float32), frame_song)
    hc = rng.uniform(0.1, 1.0, (pool.n_songs, 4)).astype(np.float32)
    hc /= hc.sum(axis=1, keepdims=True)
    return UserData("u0", pool, labels, hc_rows=hc)


def session_committee(data, device, *, device_members: bool = False):
    """The JAX matrix's ``_committee``: a GaussianNB and an SGD member
    fitted on the user's own frames (the port's fits, scikit-learn's bit
    for bit)."""
    from consensus_entropy_tpu_torch.models.committee import Committee
    from consensus_entropy_tpu_torch.models.members import (
        GNBMember,
        SGDMember,
    )

    X = data.pool.X
    y = np.array([data.labels[s] for s in np.repeat(
        data.pool.song_ids, data.pool.counts)], np.int32)
    return Committee([GNBMember("gnb.it_0").fit(X, y),
                      SGDMember("sgd.it_0", seed=0).fit(X, y)],
                     device_members=device_members, device=device)


def session_run(data, path: str, mode: str, device, *, committee=None,
                device_members: bool = False) -> dict:
    from consensus_entropy_tpu_torch.al.loop import ALLoop
    from consensus_entropy_tpu_torch.config import ALConfig

    os.makedirs(path, exist_ok=True)
    com = committee if committee is not None else session_committee(
        data, device, device_members=device_members)
    cfg = ALConfig(queries=SESSION["queries"], epochs=SESSION["epochs"],
                   mode=mode, seed=SESSION["seed"])
    return ALLoop(cfg, device=device).run_user(com, data, path,
                                               seed=SESSION["seed"])


def _queried(path: str):
    from consensus_entropy_tpu_torch.al import state as al_state

    return al_state.ALState.load(path).queried


def kill_and_resume(run, load, point: str, at: int, path: str) -> dict:
    """``run(path, committee=None)`` killed at hit ``at`` of ``point``,
    then resumed from the workspace ``load(path)`` gives; returns the
    resumed run's result, the audit trail and the seconds of each part."""
    from consensus_entropy_tpu_torch.resilience import faults

    t0 = time.perf_counter()
    with faults.inject(faults.FaultRule(point, "kill", at=at)) as inj:
        try:
            run(path)
        except faults.InjectedKill:
            pass
        else:
            raise AssertionError(f"{point}@{at}: the run was never killed")
    if not inj.fired:
        raise AssertionError(f"{point} never fired")
    t1 = time.perf_counter()
    res = run(path, committee=load(path))
    return {"result": res, "fired": inj.fired, "killed_s": t1 - t0,
            "resumed_s": time.perf_counter() - t1}


def _same_floats(got, want, what, tol=None) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or (
            not np.array_equal(got, want) if tol is None
            else not np.allclose(got, want, **tol)):
        raise AssertionError(f"{what}: {got.tolist()} against "
                             f"{want.tolist()}")


def session_leg(root: str, device) -> dict:
    """The per-session rows at the device fault points (``DEVICE_ROWS``,
    mode mc): each killed run resumes to its unfaulted run on the same
    device, trajectory and queried songs equal."""
    from consensus_entropy_tpu_torch.al import workspace

    data = session_user()
    rows, base = [], {}
    for dm in (False, True):
        p = os.path.join(root, f"base_{'device' if dm else 'host'}")
        base[dm] = (session_run(data, p, "mc", device, device_members=dm),
                    _queried(p))
    for point, dm in DEVICE_ROWS:
        at = BOUNDARIES[point][0]
        p = os.path.join(root, f"{point}_{'device' if dm else 'host'}")
        out = kill_and_resume(
            lambda path, committee=None, dm=dm: session_run(
                data, path, "mc", device, committee=committee,
                device_members=dm),
            lambda path, dm=dm: workspace.load_committee(
                path, device_members=dm, device=device), point, at, p)
        ref, queried = base[dm]
        _same_floats(out["result"]["trajectory"], ref["trajectory"],
                     f"session {point}@{at} trajectory")
        if _queried(p) != queried:
            raise AssertionError(f"session {point}@{at}: queried songs "
                                 "differ from the unfaulted run's")
        rows.append({"point": point, "at": at, "device_members": dm,
                     "killed_s": round(out["killed_s"], 3),
                     "resumed_s": round(out["resumed_s"], 3)})
    return {"rows": rows}


def qbdc_configs():
    from consensus_entropy_tpu_torch.config import CNNConfig, TrainConfig

    return (CNNConfig(**QBDC_CNN),
            TrainConfig(batch_size=QBDC["batch_size"]))


def qbdc_user(device, seed: int = QBDC["user_seed"]):
    """20 songs (F=8, 3-5 frames a song) with waveforms of 8,300-9,500
    samples, a GaussianNB and an SGD member fitted on noisy frames and two
    fresh narrow vgg members: the draws of ``tests/test_torch_cnn_fleet.py
    ::_user``, each vgg initialized as Flax does from ``key(seed + i)``.
    Returns the ``UserData`` and a committee factory."""
    from consensus_entropy_tpu_torch import prng
    from consensus_entropy_tpu_torch.al.loop import UserData
    from consensus_entropy_tpu_torch.data.audio import DeviceWaveformStore
    from consensus_entropy_tpu_torch.device import resolve_device
    from consensus_entropy_tpu_torch.models.committee import (
        CNNMember,
        Committee,
        FramePool,
    )
    from consensus_entropy_tpu_torch.models.members import (
        GNBMember,
        SGDMember,
    )
    from consensus_entropy_tpu_torch.models.short_cnn import init_variables

    dev = resolve_device(device)
    cnn_cfg, train_cfg = qbdc_configs()
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4, 8)).astype(np.float32) * 2.5
    rows, sids, labels = [], [], {}
    for i in range(20):
        sid, c = 200 + i, int(rng.integers(0, 4))
        labels[sid] = c
        k = int(rng.integers(3, 6))
        rows.append(centers[c]
                    + rng.standard_normal((k, 8)).astype(np.float32))
        sids += [sid] * k
    x = np.vstack(rows)
    # the first song is the longest, so every user's store has one shape
    waves = {s: rng.standard_normal(
        9500 if s == 200 else int(rng.integers(8300, 9500))).astype(
        np.float32) for s in labels}
    noisy = x + rng.standard_normal(x.shape).astype(np.float32) * 4
    y = np.array([labels[s] for s in sids])
    host = [GNBMember("gnb.it_0").fit(noisy, y),
            SGDMember("sgd.it_0", seed=0).fit(noisy, y)]
    cnn = [init_variables(prng.key(seed + i, "cpu"), cnn_cfg, "cpu")
           for i in range(2)]
    data = UserData("q0", FramePool(x, sids), labels,
                    store=DeviceWaveformStore(waves, cnn_cfg.input_length,
                                              dev))

    def committee():
        return Committee(
            copy.deepcopy(host),
            [CNNMember(f"cnn.it_{i}",
                       {k: t.to(dev) for k, t in v.items()}, cnn_cfg)
             for i, v in enumerate(cnn)], cnn_cfg, train_cfg, device=dev)

    return data, committee


def qbdc_run(data, make_committee, path: str, device, *,
             committee=None) -> dict:
    from consensus_entropy_tpu_torch.al.loop import ALLoop
    from consensus_entropy_tpu_torch.config import ALConfig

    os.makedirs(path, exist_ok=True)
    cfg = ALConfig(queries=QBDC["queries"], epochs=QBDC["epochs"],
                   mode="qbdc", seed=QBDC["seed"], qbdc_k=QBDC["qbdc_k"],
                   ckpt_dtype="float32")
    return ALLoop(cfg, retrain_epochs=QBDC["retrain_epochs"],
                  device=device).run_user(
        committee if committee is not None else make_committee(), data,
        path)


def qbdc_leg(root: str, device) -> dict:
    """The qbdc rows (``QBDC_BOUNDARIES``): each killed run resumes to the
    unfaulted run on the same device, queried songs equal, F1s within
    ``CNN_TOL``."""
    from consensus_entropy_tpu_torch.al import workspace

    cnn_cfg, train_cfg = qbdc_configs()
    data, make_committee = qbdc_user(device)
    p = os.path.join(root, "base_qbdc")
    ref = qbdc_run(data, make_committee, p, device)
    queried = _queried(p)
    rows = []
    for point, at in QBDC_BOUNDARIES:
        p = os.path.join(root, f"qbdc_{point}")
        out = kill_and_resume(
            lambda path, committee=None: qbdc_run(
                data, make_committee, path, device, committee=committee),
            lambda path: workspace.load_committee(path, cnn_cfg, train_cfg,
                                                  device=device),
            point, at, p)
        if _queried(p) != queried:
            raise AssertionError(f"qbdc {point}@{at}: queried songs differ "
                                 "from the unfaulted run's")
        _same_floats(out["result"]["trajectory"], ref["trajectory"],
                     f"qbdc {point}@{at} trajectory", CNN_TOL)
        diff = float(np.max(np.abs(np.subtract(
            out["result"]["trajectory"], ref["trajectory"]))))
        rows.append({"point": point, "at": at,
                     "max_f1_diff": diff,
                     "killed_s": round(out["killed_s"], 3),
                     "resumed_s": round(out["resumed_s"], 3)})
    return {"rows": rows}


# -- the real-worker legs --------------------------------------------------

#: each user's AL run in every leg (the JAX gates' ``make_cfg("mc",
#: epochs=2)``: q 4, 2 iterations); ``-n 4`` keeps all 6 synthetic users
USER_FLAGS = ["-q", "4", "-e", "2", "-n", "4", "-m", "mc"]
TREE_SEED = 0
#: worker flags: 2 sessions live (the JAX gates' ``tests/fabric_worker.py``)
WORKER_FLAGS = ["--serve", "2"]
#: seconds one coordinator incarnation may take before the leg fails
WEDGE_S = 300.0
#: the elastic leg's per-score delay on every worker (``pool.score:delay``,
#: values untouched): h0 is still on its first user when the coordinator
#: sees the admission.  The replacement leases in any case (the
#: coordinator waits for every worker to read its close); it takes users
#: only where it starts before the survivor has run them
ELASTIC_DELAY_S = 1.0
#: the remedy leg's per-score delay on h0: its two users outlast the fast
#: hosts' by about a second (the JAX gate's 0.3 and 0.5 s over 8 users)
REMEDY_DELAY_S = 0.5
#: the deadline step's hold of each checkpoint commit on h0
#: (``state.save:delay``): a fenced session is released once its commit is
#: durable, so h0's fence ack lands this long after the fence at the
#: earliest, past the coordinator's first deadline check however loaded
#: its poll (a coordinator that reads the ack first commits the fence and
#: counts no timeout)
REMEDY_COMMIT_HOLD_S = 2.0
#: the deadline step's skew hold: the fast hosts have emptied and h0 has
#: admitted both its users well before it ends, so the one victim is h0
#: and its shed is a fence (under load, the rebalance step's 0.2 s can
#: pick a lagging fast host, or find h0's second user still queued)
REMEDY_DEADLINE_HOLD_S = 1.5
#: the gray leg's hold of every dispatch on h0: above the detector's 2-s
#: floor (the JAX gate holds 5 s)
GRAY_STALL_S = 3.0
SOAK_SLO = {"interactive": 0.5, "batch": 600.0}
#: the soak's per-score delay on every worker: a synthetic user's run
#: takes about 0.1 s on the CPU, and the hold needs users that burn the
#: 0.5-s interactive SLO (the JAX gate's users take seconds)
SOAK_DELAY_S = 0.5
#: the drain leg's coordinator kill points (``elastic_check.sh:19-26``)
DRAIN_POINTS = ("fabric.drain", "fabric.migrate.fence",
                "fabric.migrate.commit")
#: the drain and obs legs' per-score delay on every worker: each session
#: outlives the drain decision and its fence round trip (the JAX gates'
#: 0.3 and 0.2 s hold users of 3 iterations; these have 2)
DRAIN_DELAY_S = 1.0
#: the obs leg's queue-age bound on every worker (``--priority-aging-s``,
#: the JAX gate's ``CETPU_OBS_AGING``): with one session live a host's
#: second user waits past it, so ``batch_aging`` rises
OBS_AGING_S = 0.2
#: the slo leg's serve cohort (``slo_check.sh:51-56``): 2 sessions live
#: and a planner epoch short enough for a cohort of 6
SLO_SERVE = {"target_live": 2, "planner_epoch": 2}
#: the mesh leg's host widths (``tests/test_pool_mesh.py:360``)
MESH_DEVICES = (4, 1)
#: the mesh leg's per-score delay on h0: it finishes no user between its
#: first admission and its kill, however late the coordinator polls
MESH_DELAY_S = 1.0


class LegFailed(AssertionError):
    """A leg's gate condition did not hold."""


def _check(cond, what) -> None:
    if not cond:
        raise LegFailed(what)


@contextlib.contextmanager
def _quiet():
    """A CLI's chatter off this command's standard output (its JSON
    lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        yield out


class Tree:
    """The seeded synthetic tree, its pre-trained registry and every
    user's sequential run (the parity reference)."""

    def __init__(self, root: str, device: str, log=print):
        from consensus_entropy_tpu_torch.cli import amg_test, deam_classifier
        from consensus_entropy_tpu_torch.data.synth import build_synth_roots

        self.root = root
        self.device = device
        roots = build_synth_roots(os.path.join(root, "tree"),
                                  np.random.default_rng(TREE_SEED))
        self.amg, self.models = roots["amg"], roots["models"]
        flags = ["--models-root", self.models, "--deam-root", roots["deam"],
                 "--amg-root", self.amg, "--device", device]
        t0 = time.perf_counter()
        for model in ("gnb", "sgd"):
            with _quiet() as out:
                rc = deam_classifier.main(["-cv", "1", "-m", model, *flags])
            _check(rc == 0, f"deam_classifier -m {model}: exit {rc}\n"
                            f"{out.getvalue()[-2000:]}")
        with _quiet() as out:
            rc = amg_test.main([*USER_FLAGS, *flags])
        _check(rc == 0, f"sequential amg_test: exit {rc}\n"
                        f"{out.getvalue()[-2000:]}")
        self.seq = self.states(self.models)
        self.users = sorted(self.seq, key=int)
        self.pools = self._pools()
        log(f"fault_matrix: tree with {len(self.users)} users, registry "
            f"and sequential runs in {time.perf_counter() - t0:.1f} s")

    def _pools(self) -> dict:
        from consensus_entropy_tpu_torch.cli.amg_test import _pool_sizes
        from consensus_entropy_tpu_torch.config import PathsConfig
        from consensus_entropy_tpu_torch.data import amg

        paths = PathsConfig(models_root=self.models, amg_root=self.amg)
        anno = amg.load_annotations(paths.amg_annotations_mat,
                                    paths.amg_mapping_mat)
        pool = amg.load_feature_pool(paths.amg_dataset_csv,
                                     paths.amg_features_dir)
        return _pool_sizes(pool, anno, [int(u) for u in self.users])

    @staticmethod
    def states(models: str) -> dict:
        """``{user: al_state.json}`` of every finished mc workspace."""
        users = os.path.join(models, "users")
        out = {}
        for u in sorted(os.listdir(users)):
            p = os.path.join(users, u, "mc", "al_state.json")
            if os.path.exists(p):
                with open(p) as f:
                    out[u] = json.load(f)
        return out


def _users_parity(tree, models, name) -> None:
    """Each tree user's ``al_state.json`` under ``models`` is its
    sequential run's."""
    states = Tree.states(models)
    for u in tree.users:
        _check(states.get(u) == tree.seq[u],
               f"{name}: user {u}'s state is not its sequential run's")


class Fabric:
    """One leg directory: a registry copy, and coordinator incarnations
    over ``amg_test --fabric-worker`` workers.  ``faults``: host ->
    ``CETPU_FAULTS`` spec for that host's workers; ``mesh``: host -> the
    width of the pool mesh it serves on (``--mesh`` of that many entries
    of the tree's device, as ``amg_test --hosts --mesh-devices`` spawns
    it); ``worker_flags``: the workers' serve flags."""

    def __init__(self, tree: Tree, name: str, *,
                 faults: dict | None = None, mesh: dict | None = None,
                 worker_flags=WORKER_FLAGS):
        self.tree = tree
        self.name = name
        self.models = os.path.join(tree.root, name, "models")
        shutil.copytree(os.path.join(tree.models, "pretrained"),
                        os.path.join(self.models, "pretrained"))
        self.users_dir = os.path.join(self.models, "users")
        self.fabric_dir = os.path.join(self.users_dir, "fabric")
        self.journal_path = os.path.join(self.users_dir,
                                         "serve_journal.jsonl")
        os.makedirs(self.fabric_dir)
        self.users = tree.users
        self.faults = faults or {}
        self.mesh = mesh or {}
        self.worker_flags = list(worker_flags)
        self.procs = []
        #: host -> spawn wall time, and -> its first lease's wall time
        self.spawned, self.leased = {}, {}

    def spawn(self, host_id: str):
        from consensus_entropy_tpu_torch.serve.hosts import fabric_paths

        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        env.pop("CETPU_FAULTS", None)
        # one host thread a worker, as the card host's cores are shared
        # by every worker and the coordinator
        env.setdefault("OMP_NUM_THREADS", "1")
        if host_id in self.faults:
            env["CETPU_FAULTS"] = self.faults[host_id]
        mesh = []
        if self.mesh.get(host_id, 1) > 1:
            one = "cpu" if self.tree.device == "cpu" else "cuda:0"
            mesh = ["--mesh", ",".join([one] * self.mesh[host_id])]
        cmd = [sys.executable, "-m",
               "consensus_entropy_tpu_torch.cli.amg_test", *USER_FLAGS,
               "--max-users", str(len(self.users)), *self.worker_flags,
               *mesh,
               "--models-root", self.models, "--amg-root", self.tree.amg,
               "--device", self.tree.device, "--fabric-worker", host_id,
               "--fabric-dir", self.fabric_dir]
        log = open(fabric_paths(self.fabric_dir, host_id)["log"], "ab")
        try:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                    env=env)
        finally:
            log.close()
        self.procs.append(proc)
        self.spawned[host_id] = time.time()
        self.leased.pop(host_id, None)
        return proc

    def watch_leases(self) -> None:
        """Note each spawned host's first lease (the worker is up) by its
        beat's wall time; a host first seen after its second beat (once
        the run is over) is noted by that later beat."""
        from consensus_entropy_tpu_torch.serve.hosts import (
            fabric_paths,
            read_lease,
        )

        for hid, t_spawn in self.spawned.items():
            if hid in self.leased:
                continue
            lease = read_lease(fabric_paths(self.fabric_dir, hid)["lease"])
            if lease and float(lease.get("t", 0.0)) >= t_spawn:
                self.leased[hid] = float(lease["t"])

    def lease_times(self) -> dict:
        return {h: round(self.leased[h] - self.spawned[h], 3)
                for h in sorted(self.leased)}

    def run(self, config, *, on_poll=None, kill_at=None, keep_open=False,
            users=None, classes=None, report=None, alerts=None,
            status=None, tracer=None, driver=None):
        """One coordinator incarnation.  ``kill_at``: a fault point where
        this coordinator is killed (hit 1); returns ``(summary or None,
        killed, coordinator)``.  ``driver(coord)``: starts a trace driver
        against it and returns a ``stop()``."""
        from consensus_entropy_tpu_torch.resilience import faults
        from consensus_entropy_tpu_torch.serve import (
            AdmissionJournal,
            FabricCoordinator,
        )

        journal = AdmissionJournal(self.journal_path)
        deadline = time.monotonic() + WEDGE_S

        def poll(coord):
            self.watch_leases()
            if time.monotonic() > deadline:
                raise LegFailed(
                    f"{self.name}: the coordinator wedged past {WEDGE_S} s "
                    f"(unresolved {sorted(coord._unresolved)})")
            if on_poll is not None:
                on_poll(coord)

        coord = FabricCoordinator(journal, self.fabric_dir, config,
                                  on_poll=poll, report=report,
                                  alerts=alerts, status=status,
                                  tracer=tracer)
        todo = self.users if users is None else users
        pools = {u: self.tree.pools[u] for u in self.tree.users}
        stop = driver(coord) if driver is not None else None
        killed, summary = False, None
        try:
            rule = (faults.inject(faults.FaultRule(kill_at, "kill", at=1))
                    if kill_at else contextlib.nullcontext())
            with rule:
                try:
                    summary = coord.run(todo, self.spawn, classes=classes,
                                        pools=pools, keep_open=keep_open)
                except faults.InjectedKill:
                    if kill_at is None:
                        raise
                    killed = True
        finally:
            # a worker that started as the run ended (the coordinator
            # waits for every worker to read its close) leased meanwhile
            self.watch_leases()
            if stop is not None:
                stop()
            journal.close()
            # a killed incarnation leaves its per-host handles (and their
            # single-writer locks) open: release them for the rerun
            for h in coord.hosts.values():
                h.assign.close()
                h.tail.close()
                if h.span_tail is not None:
                    h.span_tail.close()
            self.reap()
        if kill_at is not None:
            _check(killed, f"{self.name}: {kill_at} never fired")
        return summary, killed, coord

    def reap(self) -> None:
        """Kill and wait for every worker this leg started (a finished run
        has already closed them; a killed one has SIGKILLed them)."""
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()

    # -- the gates' checks --------------------------------------------------

    def records(self, event=None) -> list:
        from consensus_entropy_tpu_torch.obs import export

        recs = export.read_jsonl_tolerant(self.journal_path)
        return [r for r in recs if event is None or r.get("event") == event]

    def wals(self) -> list:
        return sorted(glob.glob(os.path.join(self.fabric_dir,
                                             "events_*.jsonl")))

    def check(self) -> dict:
        """The JAX gates' ``check_parity_and_owners``: the journal and
        every per-host WAL validate; each user ran to a ``finish`` on
        exactly one host; each user's state is its sequential run's."""
        from consensus_entropy_tpu_torch.obs import export
        from consensus_entropy_tpu_torch.serve import (
            AdmissionJournal,
            validate_journal_file,
        )

        users = self.users
        bad = validate_journal_file(self.journal_path)
        for wal in self.wals():
            bad += validate_journal_file(wal)
        _check(bad == [], f"{self.name}: journal violations: {bad[:5]}")
        ran = {}
        for wal in self.wals():
            for rec in export.read_jsonl_tolerant(wal):
                if rec.get("event") == "finish" and not rec.get("skipped"):
                    ran.setdefault(str(rec["user"]), []).append(wal)
        for u in users:
            _check(len(ran.get(u, ())) == 1,
                   f"{self.name}: user {u} ran to a finish on "
                   f"{len(ran.get(u, ()))} host(s): {ran.get(u)}")
        st = AdmissionJournal(self.journal_path).state
        _check(set(users) <= st.finished and not st.pending,
               f"{self.name}: finished {sorted(st.finished)}, pending "
               f"{sorted(st.pending)}")
        _users_parity(self.tree, self.models, self.name)
        return {"users": len(users), "wals": len(self.wals())}


def _first_admission_on(host):
    """``on_poll``: SIGKILL ``host`` once the journal shows it admitted a
    user; the kill's wall time lands in the returned dict."""
    state = {}

    def on_poll(coord):
        if state:
            return
        st = coord.journal.state
        if any(h == host and st.last.get(u) == "admit"
               for u, h in st.assigned.items()):
            coord.hosts[host].proc.kill()
            state["t"] = time.time()

    return on_poll, state


def elastic_leg(tree: Tree) -> dict:
    """``elastic_check.sh`` leg 1, every score slowed by
    ``ELASTIC_DELAY_S``."""
    from consensus_entropy_tpu_torch.obs import export
    from consensus_entropy_tpu_torch.serve import (
        AdmissionJournal,
        FabricConfig,
    )

    slow = f"pool.score:delay={ELASTIC_DELAY_S}@1x-1"
    fab = Fabric(tree, "elastic",
                 faults={h: slow for h in ("h0", "h1", "h2")})
    on_poll, kill = _first_admission_on("h0")
    summary, _, _ = fab.run(
        FabricConfig(hosts=2, min_hosts=2, max_hosts=3, planner_epoch=4),
        on_poll=on_poll)
    _check(kill, "elastic: h0 was never killed")
    _check(summary["revocations"] == 1 and summary["spawns"] >= 1,
           f"elastic: {summary['revocations']} revocations, "
           f"{summary['spawns']} spawns")
    _check(sorted(summary["finished"]) == sorted(fab.users),
           f"elastic: finished {summary['finished']}")
    st = AdmissionJournal(fab.journal_path).state
    _check(st.hosts.get("h0") == "revoke", f"elastic: h0 {st.hosts}")
    _check("h2" in st.fleet_hosts(), f"elastic: fleet {st.fleet_hosts()}")
    _check(any(r.get("host") == "h2" for r in fab.records("spawn")),
           "elastic: no spawn record for the replacement")
    checked = fab.check()
    per_host = {}
    for hid, status in summary["hosts"].items():
        if status == "revoked":
            continue
        last = None
        for rec in export.read_jsonl_tolerant(
                os.path.join(fab.fabric_dir, f"events_{hid}.jsonl")):
            if rec.get("event") == "planner" and rec.get("fleet"):
                last = tuple(rec.get("edges") or ())
        if last is not None:
            per_host[hid] = last
    fleet = (summary.get("fleet_planner") or {}).get("edges")
    _check(per_host, "elastic: no host ever adopted fleet edges")
    _check(len(set(per_host.values())) == 1,
           f"elastic: hosts ended on different edges {per_host}")
    _check(list(next(iter(per_host.values()))) == fleet
           and st.planner_edges == fleet,
           f"elastic: hosts {per_host}, fleet {fleet}, journal "
           f"{st.planner_edges}")
    lease = fab.leased.get("h2")
    _check(lease is not None, "elastic: the replacement never leased")
    served = {}
    for wal in fab.wals():
        host = os.path.basename(wal)[len("events_"):-len(".jsonl")]
        served[host] = sum(1 for r in export.read_jsonl_tolerant(wal)
                           if r.get("event") == "finish"
                           and not r.get("skipped"))
    return {**checked, "spawns": summary["spawns"],
            "served": served,
            "revocations": summary["revocations"],
            "fleet": st.fleet_hosts(), "edges": fleet,
            "spawn_to_lease_s": fab.lease_times(),
            "kill_to_respawn_lease_s": None if lease is None
            else round(lease - kill["t"], 3)}


def _start_when_up(users, pools, hosts=None):
    """``on_poll``: submit ``users`` once every host of the fleet (``hosts``
    of them, by default the config's) joined, then close the intake.  The
    load starts on every host at once, so the slow host's share outlasts
    the others' however far apart the workers came up (seconds, on a
    loaded host)."""
    state = {"done": False}

    def on_poll(coord):
        want = coord.config.hosts if hosts is None else hosts
        if state["done"] or len(coord.hosts) < want \
                or not all(h.joined for h in coord.hosts.values()):
            return
        for u in users:
            coord.submit(u, pool=pools[u])
        coord.close_intake()
        state["done"] = True

    return on_poll


def _run_once_up(fab, config, *, hosts=None, also=None, **kw):
    """One incarnation whose users start once its fleet (``hosts`` hosts)
    is up; ``also(coord)`` runs on every poll after that hook."""
    start = _start_when_up(fab.users, fab.tree.pools, hosts)

    def on_poll(coord):
        start(coord)
        if also is not None:
            also(coord)

    return fab.run(config, users=[], keep_open=True, on_poll=on_poll, **kw)


def _remedy_actions(fab) -> list:
    return [r.get("action") for r in fab.records("remedy")]


def remedy_leg(tree: Tree) -> dict:
    """``remedy_check.sh`` legs 1-3; each first incarnation's users are
    submitted once the three hosts are up."""
    from consensus_entropy_tpu_torch.serve import (
        AdmissionJournal,
        FabricConfig,
    )

    def config(**kw):
        kw = {"remedy_hold_s": 0.2, **kw}
        return FabricConfig(hosts=3, min_hosts=3, max_hosts=3, remedy=True,
                            remedy_cooldown_s=600.0, remedy_skew=1,
                            placement="load", **kw)

    out = {}
    slow = {"h0": f"pool.score:delay={REMEDY_DELAY_S}@1x-1"}
    fab = Fabric(tree, "remedy_rebalance", faults=slow)
    s, _, _ = _run_once_up(fab, config())
    _check(s["remedies"] >= 1 and s["migrations"] >= 1,
           f"remedy rebalance: {s['remedies']} remedies, "
           f"{s['migrations']} migrations")
    _check(s["fence_timeouts"] == 0 and s["drains"] == 0
           and s["revocations"] == 0, f"remedy rebalance: {s}")
    _check("rebalance" in _remedy_actions(fab),
           f"remedy rebalance: {_remedy_actions(fab)}")
    st = AdmissionJournal(fab.journal_path).state
    _check(sorted(st.fleet_hosts()) == ["h0", "h1", "h2"],
           f"remedy rebalance: fleet {st.fleet_hosts()}")
    out["rebalance"] = {**fab.check(), "remedies": s["remedies"],
                        "migrations": s["migrations"], "fences": s["fences"],
                        "spawn_to_lease_s": fab.lease_times()}

    held = {"h0": f"{slow['h0']},state.save:delay={REMEDY_COMMIT_HOLD_S}"
                  "@1x-1"}
    fab = Fabric(tree, "remedy_deadline", faults=held)
    s, _, _ = _run_once_up(fab, config(
        fence_deadline_s=0.01, remedy_hold_s=REMEDY_DEADLINE_HOLD_S))
    _check(s["remedies"] >= 1 and s["fence_timeouts"] >= 1,
           f"remedy deadline: {s['remedies']} remedies, "
           f"{s['fence_timeouts']} fence timeouts")
    _check("fence_timeout" in _remedy_actions(fab),
           f"remedy deadline: {_remedy_actions(fab)}")
    out["deadline"] = {**fab.check(), "fence_timeouts": s["fence_timeouts"],
                       "spawn_to_lease_s": fab.lease_times()}

    fab = Fabric(tree, "remedy_kill", faults=slow)
    _run_once_up(fab, config(), kill_at="fabric.remedy")
    # fired before the append: the killed decision never journaled
    _check(_remedy_actions(fab) == [],
           f"remedy kill: {_remedy_actions(fab)}")
    s, _, _ = fab.run(config())
    out["kill"] = {**fab.check(), "rerun_remedies": s["remedies"],
                   "spawn_to_lease_s": fab.lease_times()}
    return out


class _Alerts:
    """An alert watcher's report: keeps every event."""

    def __init__(self):
        self.events = []

    def event(self, kind, /, **kw):
        self.events.append((kind, kw))


def gray_leg(tree: Tree) -> dict:
    """``gray_check.sh`` legs 1-2, each dispatch on h0 held
    ``GRAY_STALL_S``; each first incarnation's users are submitted once
    the three hosts are up."""
    from consensus_entropy_tpu_torch.obs.alerts import AlertWatcher
    from consensus_entropy_tpu_torch.serve import (
        AdmissionJournal,
        FabricConfig,
    )

    # an absolute floor above the lease cadence and normal step walls,
    # inside the stall; short evidence gates; no lift mid-run
    config = FabricConfig(hosts=3, min_hosts=3, max_hosts=3,
                          placement="load", gray=True, gray_ratio=3.0,
                          gray_min_s=2.0, gray_hold_s=0.5, gray_drain_s=1.0,
                          gray_clear_s=600.0)
    stall = {"h0": f"serve.dispatch:stall={GRAY_STALL_S}@1x-1"}
    out = {}
    fab = Fabric(tree, "gray_ladder", faults=stall)
    rep = _Alerts()
    s, _, _ = _run_once_up(fab, config, alerts=AlertWatcher(rep))
    _check(s["probations"] >= 1 and s["gray_drains"] >= 1
           and s["migrations"] >= 1,
           f"gray ladder: {s['probations']} probations, "
           f"{s['gray_drains']} gray drains, {s['migrations']} migrations")
    _check(s["drains"] == 0 and s["revocations"] == 0, f"gray ladder: {s}")
    h0_alerts = [kw for k, kw in rep.events if k == "alert"
                 and kw.get("kind") == "gray_suspect"
                 and kw.get("host") == "h0"]
    _check(any(a.get("signals") for a in h0_alerts),
           f"gray ladder: gray_suspect alerts for h0 {h0_alerts}")
    probations = [(r["host"], r["on"]) for r in fab.records("probation")]
    _check(("h0", True) in probations, f"gray ladder: {probations}")
    _check(any(r.get("action") == "gray_drain" and r.get("host") == "h0"
               for r in fab.records("remedy")),
           "gray ladder: no gray_drain of h0")
    st = AdmissionJournal(fab.journal_path).state
    _check(sorted(st.fleet_hosts()) == ["h0", "h1", "h2"]
           and "h0" in st.probation,
           f"gray ladder: fleet {st.fleet_hosts()}, probation "
           f"{st.probation}")
    out["ladder"] = {**fab.check(), "probations": s["probations"],
                     "gray_drains": s["gray_drains"],
                     "migrations": s["migrations"],
                     "spawn_to_lease_s": fab.lease_times()}

    fab = Fabric(tree, "gray_kill", faults=stall)
    _run_once_up(fab, config, alerts=AlertWatcher(_Alerts()),
                 kill_at="fabric.gray")
    _check(fab.records("probation") == [],
           f"gray kill: {fab.records('probation')}")
    pending = AdmissionJournal(fab.journal_path).state.pending
    last_host = {r["user"]: r["host"] for r in fab.records("assign")}
    hostages = sorted(u for u in pending if last_host.get(u) == "h0")
    _check(hostages, "gray kill: the kill left nothing pending on h0")
    fab.run(config, alerts=AlertWatcher(_Alerts()))
    fin = {r["user"]: r.get("host") for r in fab.records("finish")
           if r.get("host")}
    _check(all(fin.get(u) != "h0" for u in hostages),
           f"gray kill: hostages {hostages} finished on {fin}")
    out["kill"] = {**fab.check(), "hostages": hostages,
                   "spawn_to_lease_s": fab.lease_times()}
    return out


def soak_trace(users, pools, *, pool_dist="cycle", seeds=range(5, 105),
               accept=None):
    """The JAX soak gate's trace (``soak_check.sh:103-120``) over this
    tree's users: 60 virtual seconds of Poisson arrivals, half
    interactive, a third churned; the first seed in ``seeds`` that draws
    both classes and whose arrivals ``accept`` takes.  Each arrival's pool
    is the user's own, or with ``pools=None`` the drawn size."""
    from consensus_entropy_tpu_torch.workload import Trace, TraceSpec
    from consensus_entropy_tpu_torch.workload import generate

    for seed in seeds:
        spec = TraceSpec(
            seed=seed, n_users=len(users), arrival="poisson", rate=1.0,
            class_mix=(("interactive", 0.5), ("batch", 0.5)),
            pool_dist=pool_dist, pool_sizes=(30, 100), churn_frac=0.34,
            churn_delay_s=10.0, reconnect_s=20.0, horizon_s=60.0)
        trace = generate(spec)
        arrivals = [e for e in trace.events if e["kind"] == "arrive"]
        if {e["cls"] for e in arrivals} == {"interactive", "batch"} \
                and (accept is None or accept(arrivals)):
            break
    else:
        raise LegFailed(f"soak: no {pool_dist} trace seed in the scan "
                        "range")
    ids = {f"u{i}": u for i, u in enumerate(users)}
    events = []
    for e in trace.events:
        e = dict(e, user=ids[e["user"]])
        if "pool" in e and pools is not None:
            e["pool"] = pools[e["user"]]
        events.append(e)
    return Trace(events=events, meta=trace.meta)


def soak_config():
    """The soak legs' fabric: 2 keep-open hosts, the burn-rate hold armed
    on the tight interactive SLO (real users take seconds end to end, so
    the burn detector arms and the hold fires)."""
    from consensus_entropy_tpu_torch.serve import FabricConfig

    return FabricConfig(hosts=2, lease_s=5.0, hold_on_burn=True,
                        admission_hold_s=0.5, remedy_hold_s=0.3,
                        remedy_cooldown_s=3.0,
                        slo_interactive_s=SOAK_SLO["interactive"],
                        slo_batch_s=SOAK_SLO["batch"])


def _trace_starter(trace, drivers):
    """``Fabric.run``'s ``driver``: plays ``trace`` at 0.1x through
    ``FabricTarget(coord)``; each driver lands in ``drivers``."""
    from consensus_entropy_tpu_torch.workload import FabricTarget, TraceDriver

    def start(coord):
        drv = TraceDriver(trace, FabricTarget(coord), time_scale=0.1,
                          backoff_seed=3)
        drivers.append(drv)
        drv.start()
        return drv.stop

    return start


def soak_leg(tree: Tree) -> dict:
    """``soak_check.sh`` legs 1-2."""
    from consensus_entropy_tpu_torch.fleet import FleetReport
    from consensus_entropy_tpu_torch.obs.alerts import AlertWatcher
    from consensus_entropy_tpu_torch.obs.status import StatusWriter
    from consensus_entropy_tpu_torch.workload import grade_run, load, save

    users = tree.users
    trace_path = os.path.join(tree.root, "soak_trace.jsonl")
    save(soak_trace(users, tree.pools), trace_path)
    trace = load(trace_path)
    drivers = []
    start = _trace_starter(trace, drivers)

    out = {}
    slow = {h: f"pool.score:delay={SOAK_DELAY_S}@1x-1" for h in ("h0", "h1")}
    fab = Fabric(tree, "soak", faults=slow)
    report = FleetReport(os.path.join(fab.users_dir,
                                      "fleet_metrics_fleet.jsonl"))
    # alerts are evaluated on the status-write path: without the writer
    # the watcher never emits slo_headroom
    status = StatusWriter(os.path.join(fab.users_dir, "status"),
                          "coordinator", interval_s=0.2)
    try:
        s, _, _ = fab.run(soak_config(), users=[], keep_open=True,
                          report=report, alerts=AlertWatcher(report),
                          status=status, driver=start)
        _check(drivers[0].join(timeout=120.0), "soak: the driver wedged")
    finally:
        report.close()
    g = grade_run(fab.users_dir, journal_path=fab.journal_path,
                  trace=trace, slo_s=SOAK_SLO,
                  driver_stats=drivers[0].stats.as_dict())
    det = g["deterministic"]
    _check(det["zero_loss"], f"soak: lost {det['lost_users']}")
    _check(det["journal_ok"] and det["stream_ok"],
           f"soak: journal {g['measured']['journal_errors']}, streams "
           f"{g['measured']['stream_errors']}")
    _check(s["holds"] >= 1 and s["disconnects"] >= 1,
           f"soak: {s['holds']} holds, {s['disconnects']} disconnects")
    _check(g["measured"]["alerts"].get("slo_headroom", 0) >= 1,
           f"soak: alerts {g['measured']['alerts']}")
    _check(any(r.get("action") == "admission_hold"
               for r in fab.records("remedy")), "soak: no journaled hold")
    out["soak"] = {**fab.check(), "holds": s["holds"],
                   "disconnects": s["disconnects"],
                   "alerts": g["measured"]["alerts"],
                   "spawn_to_lease_s": fab.lease_times()}

    fab = Fabric(tree, "soak_kill", faults=slow)
    drivers.clear()
    fab.run(soak_config(), users=[], keep_open=True,
            report=FleetReport(), driver=start, kill_at="fabric.remedy")
    drivers[0].join(timeout=30.0)
    _check(fab.records("remedy") == [],
           f"soak kill: {fab.records('remedy')}")
    done_before = {u for u, d in grade_run(
        fab.users_dir, journal_path=fab.journal_path, trace=trace)
        ["deterministic"]["dispositions"].items() if d == "finish"}
    cls_of = {e["user"]: e["cls"] for e in trace.events
              if e["kind"] == "arrive"}
    s, _, _ = fab.run(soak_config(), users=list(trace.users),
                      classes=cls_of, report=FleetReport())
    _check(sorted(s["finished"]) == sorted(set(trace.users) - done_before),
           f"soak kill: the rerun finished {s['finished']}, "
           f"{sorted(done_before)} before")
    g2 = grade_run(fab.users_dir, journal_path=fab.journal_path,
                   trace=trace)
    _check(g2["deterministic"]["zero_loss"],
           f"soak kill: {g2['deterministic']}")
    out["kill"] = {**fab.check(), "finished_before": len(done_before),
                   "spawn_to_lease_s": fab.lease_times()}
    return out


def force_low_water(coord, hosts: int = 3) -> None:
    """``on_poll``: the scale-down trigger of the drain drills (the JAX
    gates' ``tests/fabric_workload.py:182-198``), paired with a long
    ``scale_down_s``: the low-water timer counts as held the moment every
    joined host holds a user in flight, so the drain victim has sessions
    to fence."""
    if coord.drains:
        return
    st = coord.journal.state
    joined = [h for h in coord.hosts.values() if h.joined and h.alive]
    if len(joined) < hosts:
        return
    in_flight = set(st.in_flight)
    if all(any(st.assigned.get(u) == h.host_id for u in in_flight)
           for h in joined):
        coord._low_since = -1e18


def drain_config():
    """The drain drills' fabric: 3 elastic hosts (at least 2) whose
    low-water mark only ``force_low_water`` satisfies, users placed
    least-loaded so each host holds its share (bucket placement may
    co-locate them all, and a host with none never lets the mark hold)."""
    from consensus_entropy_tpu_torch.serve import FabricConfig

    return FabricConfig(hosts=3, min_hosts=2, max_hosts=3,
                        scale_down_s=600.0, drain_timeout_s=30.0,
                        placement="load")


def drain_leg(tree: Tree) -> dict:
    """``elastic_check.sh`` leg 2: a 3-host elastic fabric scales down
    mid-run, every score slowed by ``DRAIN_DELAY_S``; the coordinator
    killed at each of ``DRAIN_POINTS`` and rerun.  Each incarnation's
    users start once its fleet is up (the drain needs a user in flight on
    every host at once)."""
    from consensus_entropy_tpu_torch.serve import AdmissionJournal

    slow = {h: f"pool.score:delay={DRAIN_DELAY_S}@1x-1"
            for h in ("h0", "h1", "h2")}
    out = {}
    for point in DRAIN_POINTS:
        fab = Fabric(tree, "drain_" + point.split(".", 1)[1].replace(
            ".", "_"), faults=slow)
        _run_once_up(fab, drain_config(), also=force_low_water,
                     kill_at=point)
        killed = {"drains": len(fab.records("drain")),
                  "fences": len(fab.records("fence"))}
        fleet = AdmissionJournal(fab.journal_path).state.fleet_hosts()
        s, _, _ = _run_once_up(fab, drain_config(), hosts=len(fleet),
                               also=force_low_water)
        st = AdmissionJournal(fab.journal_path).state
        _check(len(st.fleet_hosts()) == 2,
               f"drain {point}: the rerun ended on {st.hosts}")
        out[point] = {**fab.check(), "killed_with": killed,
                      "drains": s["drains"], "fences": s["fences"],
                      "migrations": s["migrations"],
                      "spawn_to_lease_s": fab.lease_times()}
    return out


def skew_leg(tree: Tree) -> dict:
    """``soak_check.sh`` leg 3: the soak fabric under the first ``skew``
    trace (seeds 11-210) whose drawn pools hold a strict hot-size
    majority and still draw the cold size.  A port worker runs each tree
    user on the pool its annotations fix, so the drawn sizes stand as the
    users' enqueue-time pools: what the journal, the coordinator's bucket
    placement and the grading see."""
    from consensus_entropy_tpu_torch.fleet import FleetReport
    from consensus_entropy_tpu_torch.obs.alerts import AlertWatcher
    from consensus_entropy_tpu_torch.obs.status import StatusWriter
    from consensus_entropy_tpu_torch.serve import AdmissionJournal
    from consensus_entropy_tpu_torch.workload import grade_run, load, save

    users = tree.users
    n = len(users)

    def skewed(arrivals):
        pool_of = {e["user"]: e["pool"] for e in arrivals}
        sizes = [pool_of[f"u{i}"] for i in range(n)]
        hot_n = max(sizes.count(p) for p in set(sizes))
        return len(set(sizes)) == 2 and hot_n > n // 2 + 1

    trace_path = os.path.join(tree.root, "skew_trace.jsonl")
    save(soak_trace(users, None, pool_dist="skew", seeds=range(11, 211),
                    accept=skewed), trace_path)
    trace = load(trace_path)
    sizes = {e["user"]: e["pool"] for e in trace.events
             if e["kind"] == "arrive"}
    drawn = list(sizes.values())
    hot = max(set(drawn), key=drawn.count)
    fab = Fabric(tree, "skew")
    report = FleetReport(os.path.join(fab.users_dir,
                                      "fleet_metrics_fleet.jsonl"))
    status = StatusWriter(os.path.join(fab.users_dir, "status"),
                          "coordinator", interval_s=0.2)
    drivers = []
    try:
        fab.run(soak_config(), users=[], keep_open=True, report=report,
                alerts=AlertWatcher(report), status=status,
                driver=_trace_starter(trace, drivers))
        _check(drivers[0].join(timeout=120.0), "skew: the driver wedged")
    finally:
        report.close()
    g = grade_run(fab.users_dir, journal_path=fab.journal_path,
                  trace=trace, slo_s=SOAK_SLO,
                  driver_stats=drivers[0].stats.as_dict())
    det = g["deterministic"]
    _check(det["zero_loss"], f"skew: lost {det['lost_users']}")
    _check(det["journal_ok"] and det["stream_ok"],
           f"skew: journal {g['measured']['journal_errors']}, streams "
           f"{g['measured']['stream_errors']}")
    per_cls = g["measured"]["per_class"]
    for cls in ("interactive", "batch"):
        row = per_cls.get(cls)
        _check(row and row["n"] >= 1
               and all(k in row for k in ("p50_s", "p95_s", "p99_s")),
               f"skew: class {cls} graded {row}")
    st = AdmissionJournal(fab.journal_path).state
    _check({u: st.pools.get(u) for u in sizes} == sizes,
           f"skew: journaled pools {st.pools}, drawn {sizes}")
    return {**fab.check(), "hot_pool": hot,
            "hot_users": drawn.count(hot), "pools": sizes,
            "per_class": {c: {k: per_cls[c][k]
                              for k in ("n", "p50_s", "p95_s", "p99_s")}
                          for c in ("interactive", "batch")},
            "spawn_to_lease_s": fab.lease_times()}


def mesh_leg(tree: Tree) -> dict:
    """``mesh_check.sh`` leg 2 (``tests/test_pool_mesh.py:360``): h0
    serves through a 4-way pool mesh (``--mesh`` of four entries of the
    tree's device: ``cuda:0`` on the card, ``cpu`` under ``--device
    cpu``), h1 through one device; h0, every score slowed by
    ``MESH_DELAY_S``, is SIGKILLed at its first admission and every user
    finishes on h1 with its sequential run's state."""
    from consensus_entropy_tpu_torch.obs import export
    from consensus_entropy_tpu_torch.serve import FabricConfig

    fab = Fabric(tree, "mesh", mesh={"h0": MESH_DEVICES[0]},
                 faults={"h0": f"pool.score:delay={MESH_DELAY_S}@1x-1"})
    on_poll, kill = _first_admission_on("h0")
    summary, _, coord = fab.run(
        FabricConfig(hosts=2, lease_s=5.0, mesh_devices=MESH_DEVICES),
        on_poll=on_poll)
    _check(kill, "mesh: h0 was never killed")
    _check(summary["revocations"] == 1
           and summary["hosts"].get("h0") == "revoked"
           and not summary["failed"] and not summary["poisoned"],
           f"mesh: {summary}")
    widths = (coord.hosts["h0"].devices, coord.hosts["h1"].devices)
    _check(widths == MESH_DEVICES, f"mesh: the heartbeats advertised "
                                   f"{widths}, not {MESH_DEVICES}")
    checked = fab.check()
    fin = {str(r["user"]): os.path.basename(wal)
           for wal in fab.wals() for r in export.read_jsonl_tolerant(wal)
           if r.get("event") == "finish" and not r.get("skipped")}
    _check(set(fin.values()) == {"events_h1.jsonl"},
           f"mesh: finishes {fin}")
    (revoke,) = fab.records("revoke")
    return {**checked, "devices": list(widths),
            "revocations": summary["revocations"],
            "kill_to_revoke_s": round(float(revoke["t"]) - kill["t"], 3),
            "spawn_to_lease_s": fab.lease_times()}


def fsck_leg(tree: Tree) -> dict:
    """``fsck_check.sh`` legs 1 and 2a: a full 2-host run to parity; one
    byte of a mid-file framed ``enqueue`` record flipped halts replay
    (``JournalCorruption``); ``cli.fsck`` finds it (exit 1), ``--repair``
    quarantines it and sweeps a planted stale ``.tmp`` (exit 0), a second
    check is clean and the journal replays with every disposition; then a
    second coordinator incarnation claims epoch 2 and re-runs nothing."""
    from consensus_entropy_tpu_torch.cli import fsck
    from consensus_entropy_tpu_torch.obs import export
    from consensus_entropy_tpu_torch.resilience import io as dio
    from consensus_entropy_tpu_torch.serve import (
        AdmissionJournal,
        FabricConfig,
    )
    from consensus_entropy_tpu_torch.serve.journal import JournalCorruption

    def config():
        return FabricConfig(hosts=2, min_hosts=2, max_hosts=2)

    fab = Fabric(tree, "fsck")
    jp = fab.journal_path
    s, _, coord = fab.run(config())
    _check(sorted(s["finished"]) == sorted(fab.users) and coord.epoch == 1,
           f"fsck: epoch {coord.epoch}, finished {s['finished']}")
    fab.check()
    pre = AdmissionJournal(jp).state.to_dict()
    with open(jp, "rb") as f:
        lines = f.read().split(b"\n")

    def enqueue(line):
        status, rec = dio.parse_frame(line + b"\n")
        return status == "ok" and rec.get("event") == "enqueue"

    target = next(i for i, line in enumerate(lines)
                  if i >= 2 and enqueue(line))
    flipped = bytearray(lines[target])
    flipped[len(flipped) // 2] ^= 0xFF
    lines[target] = bytes(flipped)
    with open(jp, "wb") as f:
        f.write(b"\n".join(lines))
    try:
        AdmissionJournal(jp).close()
    except JournalCorruption as e:
        _check(f"{jp}:" in str(e), f"fsck: the halt names no line: {e}")
    else:
        raise LegFailed("fsck: the flipped byte was replayed")
    # a killed compaction's stray, planted after the replay probe (an
    # opening journal sweeps its own .tmp siblings)
    open(jp + ".tmp", "wb").close()
    codes = []
    for argv in ([fab.users_dir], [fab.users_dir, "--repair"],
                 [fab.users_dir]):
        with _quiet():
            codes.append(fsck.main(argv))
    _check(codes == [1, 0, 0], f"fsck: exit codes {codes} (want 1, 0, 0)")
    _check(os.path.exists(dio.quarantine_path(jp))
           and not os.path.exists(jp + ".tmp"),
           "fsck: no quarantine sidecar, or the stale .tmp stayed")
    st = AdmissionJournal(jp).state
    _check(st.finished == set(fab.users) and st.seq == pre["seq"],
           f"fsck: replayed finished {sorted(st.finished)}, seq {st.seq} "
           f"(was {pre['seq']})")
    fab.check()

    s2, _, coord2 = fab.run(config())
    claims = [r["epoch"] for r in export.read_jsonl_tolerant(jp)
              if r.get("event") == "epoch"]
    _check(coord2.epoch == 2 and claims == [1, 2]
           and AdmissionJournal(jp).state.coordinator_epoch == 2,
           f"fsck: the second incarnation claimed {coord2.epoch}, "
           f"journal epochs {claims}")
    _check(s2["users"] == 0 and s2["finished"] == [],
           f"fsck: the second incarnation ran {s2}")
    # one finish a user across every WAL: nothing ran twice
    checked = fab.check()
    return {**checked, "flipped_line": target + 1, "fsck_exits": codes,
            "epochs": claims, "spawn_to_lease_s": fab.lease_times()}


class ServeCohort:
    """The tree's users as one in-process serve cohort, the CLI's serve
    path (``amg_test --serve``) with a ``ServeConfig`` of the caller's:
    ``FleetServer`` on the tree's device over the admission journal, every
    user submitted before the engine starts, each finished user persisted
    the moment it finishes.  ``classes``: user -> priority class (default
    ``batch``); ``traced``: a span tracer on ``users/spans.jsonl``."""

    def __init__(self, tree: Tree, name: str, serve_kw: dict, *,
                 classes=None, traced: bool = False):
        from consensus_entropy_tpu_torch.al import workspace
        from consensus_entropy_tpu_torch.al.loop import UserData
        from consensus_entropy_tpu_torch.cli import amg_test
        from consensus_entropy_tpu_torch.cli.common import resolve_cnn_config
        from consensus_entropy_tpu_torch.config import ALConfig, PathsConfig
        from consensus_entropy_tpu_torch.data import amg
        from consensus_entropy_tpu_torch.device import resolve_device
        from consensus_entropy_tpu_torch.fleet import (
            FleetReport,
            FleetScheduler,
            FleetUser,
        )
        from consensus_entropy_tpu_torch.obs.trace import Tracer
        from consensus_entropy_tpu_torch.serve import (
            AdmissionJournal,
            FleetServer,
            ServeConfig,
        )

        args = amg_test.build_parser().parse_args(USER_FLAGS)
        cfg = ALConfig(queries=args.queries, epochs=args.epochs,
                       mode=args.mode, num_anno=args.num_anno,
                       seed=args.seed, qbdc_k=args.qbdc_k,
                       consensus_weighting=args.consensus_weighting)
        self.models = os.path.join(tree.root, name, "models")
        shutil.copytree(os.path.join(tree.models, "pretrained"),
                        os.path.join(self.models, "pretrained"))
        paths = PathsConfig(models_root=self.models, amg_root=tree.amg)
        self.users_dir = paths.users_dir
        os.makedirs(self.users_dir, exist_ok=True)
        self.metrics = os.path.join(self.users_dir, "fleet_metrics.jsonl")
        self.journal_path = os.path.join(self.users_dir,
                                         "serve_journal.jsonl")
        self.spans = os.path.join(self.users_dir, "spans.jsonl")
        self.serve_config = ServeConfig(**serve_kw)
        device = resolve_device(tree.device)
        anno = amg.load_annotations(paths.amg_annotations_mat,
                                    paths.amg_mapping_mat)
        hc_table = amg.hc_frequency_table(anno)
        anno, ids = amg.filter_users(anno, cfg.num_anno)
        pool = amg.load_feature_pool(paths.amg_dataset_csv,
                                     paths.amg_features_dir)
        cnn_cfg = resolve_cnn_config(None)
        classes = classes or {}
        experiment = {"seed": cfg.seed, "queries": cfg.queries,
                      "train_size": cfg.train_size}
        report = FleetReport(self.metrics)
        journal = AdmissionJournal(self.journal_path)
        tracer = Tracer(self.spans, run_id=f"{cfg.mode}-{cfg.seed}") \
            if traced else None
        server = FleetServer(
            FleetScheduler(cfg, tie_break=args.tie_break, report=report,
                           scoring_by_width=True, device=device,
                           tracer=tracer),
            self.serve_config, journal=journal)
        for u_id in ids:
            user_path, _ = workspace.create_user(
                self.users_dir, paths.pretrained_dir, u_id, cfg.mode,
                experiment=experiment)

            def factory(user_path=user_path):
                return workspace.load_committee(user_path, cnn_cfg,
                                                device=device)

            sub_pool, labels = amg.user_pool(pool, anno, u_id)
            server.submit(FleetUser(
                u_id, factory(), UserData(
                    u_id, sub_pool, labels,
                    hc_rows=hc_table.rows_for(sub_pool.song_ids)),
                user_path, seed=cfg.seed, committee_factory=factory,
                priority=classes.get(str(u_id), "batch")))
        server.close_intake()

        def on_result(rec):
            if rec["error"] is None:
                path = workspace.user_dir(self.users_dir, rec["user"],
                                          cfg.mode)
                rec["committee"].save(path)
                workspace.mark_done(path)

        try:
            self.records = server.serve((), on_result=on_result)
        finally:
            if tracer is not None:
                tracer.close()
            self.summary = report.write_summary(
                cohort=self.serve_config.target_live)
            report.close()
            journal.close()
        self.live_edges = list(server.planner.edges or ())
        _check(len(self.records) == len(ids)
               and all(r["error"] is None for r in self.records),
               f"{name}: {[(r['user'], r['error']) for r in self.records]}")
        _users_parity(tree, self.models, name)


def slo_leg(tree: Tree) -> dict:
    """``slo_check.sh``: a planner-enabled 2-class serve cohort (every
    other user interactive); every metrics line schema-valid, each
    class's admission->finish histogram and the planner's events present,
    and a fresh ``AdmissionPlanner`` restored from the replayed journal
    derives the live run's bucket edges."""
    from consensus_entropy_tpu_torch.obs import export
    from consensus_entropy_tpu_torch.serve import (
        AdmissionJournal,
        AdmissionPlanner,
        BucketRouter,
    )

    classes = {u: "interactive" if i % 2 else "batch"
               for i, u in enumerate(tree.users)}
    run = ServeCohort(tree, "slo", SLO_SERVE, classes=classes)
    _check(run.live_edges, "slo: the planner derived no edges")
    errors = export.validate_metrics_file(run.metrics)
    _check(errors == [], f"slo: schema violations {errors[:5]}")
    per_class = run.summary.get("per_class") or {}
    want = {c: sum(1 for v in classes.values() if v == c)
            for c in ("batch", "interactive")}
    _check({c: (per_class.get(c) or {}).get("admission_to_finish_s",
                                            {}).get("n")
            for c in want} == want,
           f"slo: per-class histograms {per_class}, want counts {want}")
    _check((run.summary.get("planner") or {}).get("edges")
           == run.live_edges, f"slo: summary planner "
                              f"{run.summary.get('planner')}")
    events = export.read_jsonl_tolerant(run.metrics)
    kinds = [e.get("event") for e in events]
    _check("planner_edges" in kinds, "slo: no planner_edges event")
    _check(all(e.get("cls") for e in events
               if e.get("event") in ("enqueue", "admit")),
           "slo: an enqueue or admit event without its class")
    with AdmissionJournal(run.journal_path) as replayed:
        router = BucketRouter()
        restored = AdmissionPlanner(run.serve_config, router=router,
                                    journal=replayed)
        _check(replayed.recovered
               and list(restored.edges) == run.live_edges
               and list(router.widths) == run.live_edges,
               f"slo: replayed edges {restored.edges}, router "
               f"{router.widths}, live {run.live_edges}")
        _check(set(replayed.state.classes.values())
               == {"batch", "interactive"},
               f"slo: journaled classes {replayed.state.classes}")
    return {"users": len(run.records), "metrics_lines": len(events),
            "edges": run.live_edges,
            "planner_edges_events": kinds.count("planner_edges"),
            "admission_hold_events": kinds.count("admission_hold"),
            "per_class_n": want}


def obs_leg(tree: Tree) -> dict:
    """``obs_check.sh`` legs 1-2.  Leg 1: a traced serve cohort; every
    metrics line valid, its spans merged with no orphan, the Chrome export
    loaded, ``report --validate --out`` round-tripped.  Leg 2: a traced
    3-host elastic drain and migrate (every score slowed by
    ``DRAIN_DELAY_S``, one session live a host, ``OBS_AGING_S``), the
    introspection plane on: mid-run status snapshots of the coordinator
    and a worker validate while it serves; a burn-rate ``alert`` in a
    valid metrics stream; the exported trace carries the control-plane
    lane with drain, fence and migrate spans flow-linked into the
    migrated users' traces; ``top --once`` renders the status
    directory."""
    from consensus_entropy_tpu_torch.cli import report as report_cli
    from consensus_entropy_tpu_torch.cli import top
    from consensus_entropy_tpu_torch.fleet import FleetReport
    from consensus_entropy_tpu_torch.obs import export
    from consensus_entropy_tpu_torch.obs.alerts import AlertWatcher
    from consensus_entropy_tpu_torch.obs.status import (
        StatusWriter,
        read_status_dir,
        validate_status,
    )
    from consensus_entropy_tpu_torch.obs.trace import Tracer

    run = ServeCohort(tree, "obs_trace", {"target_live": 2}, traced=True)
    errors = export.validate_metrics_file(run.metrics)
    _check(errors == [], f"obs: schema violations {errors[:5]}")
    spans = export.load_spans([run.spans])
    _check(spans and export.orphan_spans(spans) == [],
           f"obs: {len(spans)} spans, orphans "
           f"{export.orphan_spans(spans)[:3]}")
    trace = json.loads(json.dumps(export.chrome_trace(spans)))
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    _check(len(xs) == len(spans), f"obs: {len(xs)} complete events for "
                                  f"{len(spans)} spans")
    out_json = os.path.join(tree.root, "obs_trace.json")
    with _quiet():
        rc = report_cli.main([run.users_dir, "--validate", "--out",
                              out_json, "--no-text"])
    with open(out_json) as f:
        _check(rc == 0 and json.load(f)["traceEvents"],
               f"obs: report exit {rc}")
    out = {"trace": {"spans": len(spans),
                     "events": len(trace["traceEvents"])}}

    slow = f"pool.score:delay={DRAIN_DELAY_S}@1x-1"
    fab = Fabric(tree, "obs_live", faults={h: slow for h in ("h0", "h1",
                                                            "h2")},
                 worker_flags=["--serve", "1", "--priority-aging-s",
                               str(OBS_AGING_S)])
    status_dir = os.path.join(fab.users_dir, "status")
    spans_path = os.path.join(fab.users_dir, "spans.jsonl")
    metrics = os.path.join(fab.users_dir, "fleet_metrics.jsonl")
    report = FleetReport(metrics)
    tracer = Tracer(spans_path, run_id="mc-1987", host="coordinator")
    mid_run = {}

    def snapshots(coord):
        force_low_water(coord)
        if coord._unresolved:
            for host, snap in read_status_dir(status_dir).items():
                errs = validate_status(snap)
                _check(errs == [], f"obs: {host}'s mid-run snapshot: "
                                   f"{errs}")
                mid_run[host] = snap

    try:
        s, _, _ = _run_once_up(
            fab, drain_config(), also=snapshots, report=report,
            tracer=tracer, alerts=AlertWatcher(report),
            status=StatusWriter(status_dir, "coordinator", interval_s=0.2))
    finally:
        tracer.close()
        report.write_summary(cohort=len(fab.users))
        report.close()
    _check(s["drains"] == 1 and s["fences"] >= 1,
           f"obs: {s['drains']} drains, {s['fences']} fences")
    checked = fab.check()
    _check("coordinator" in mid_run
           and any(h.startswith("h") for h in mid_run),
           f"obs: mid-run snapshots of {sorted(mid_run)}")
    alerts = []
    for path in [metrics, *sorted(glob.glob(os.path.join(
            fab.users_dir, "fleet_metrics_h*.jsonl")))]:
        recs = export.read_jsonl_tolerant(path)
        _check(export.validate_metrics(recs) == [],
               f"obs: {path} fails the schema")
        alerts += [r for r in recs if r.get("event") == "alert"]
    _check(alerts, "obs: no alert fired")
    spans2 = export.load_spans([spans_path])
    names = {sp["name"] for sp in spans2 if sp.get("ctl")}
    _check({"ctl.drain", "ctl.fence", "ctl.migrate",
            "ctl.drain_done"} <= names, f"obs: control spans {names}")
    trace2 = export.chrome_trace(spans2)
    procs = {e["args"]["name"] for e in trace2["traceEvents"]
             if e.get("name") == "process_name"}
    starts = [e for e in trace2["traceEvents"] if e.get("ph") == "s"]
    ends = {e["id"] for e in trace2["traceEvents"] if e.get("ph") == "f"}
    _check("control-plane" in procs and starts
           and all(e["id"] in ends for e in starts),
           f"obs: lanes {procs}, {len(starts)} flow starts, "
           f"{len(ends)} ends")
    json.dumps(trace2)
    with _quiet() as frame:
        rc = top.main([fab.users_dir, "--once"])
    _check(rc == 0 and "coordinator" in frame.getvalue(),
           f"obs: top exit {rc}: {frame.getvalue()[-500:]}")
    out["live"] = {**checked, "drains": s["drains"], "fences": s["fences"],
                   "snapshots": sorted(mid_run),
                   "alerts": sorted({a.get("kind") for a in alerts}),
                   "control_spans": sorted(names), "flows": len(starts),
                   "spawn_to_lease_s": fab.lease_times()}
    return out


REAL_LEGS = ("elastic", "drain", "remedy", "gray", "soak", "skew", "fsck",
             "obs", "slo", "mesh")
LEGS = ("session", "qbdc", *REAL_LEGS)
#: the real-worker legs' functions
LEG_FNS = {"elastic": elastic_leg, "drain": drain_leg,
           "remedy": remedy_leg, "gray": gray_leg, "soak": soak_leg,
           "skew": skew_leg, "fsck": fsck_leg, "obs": obs_leg,
           "slo": slo_leg, "mesh": mesh_leg}


def run_leg(leg: str, root: str, device: str, tree=None) -> dict:
    """One leg into ``root``; returns its JSON record (``ok``, and the
    leg's figures or its ``error``).  The real-worker legs share ``tree``
    (made on first use)."""
    from consensus_entropy_tpu_torch.device import resolve_device

    resolve_device(device)  # no CUDA and no --device cpu: raise first
    t0 = time.perf_counter()
    rec = {"leg": leg, "device": device}
    try:
        if leg == "session":
            rec.update(session_leg(os.path.join(root, "session"), device))
        elif leg == "qbdc":
            rec.update(qbdc_leg(os.path.join(root, "qbdc"), device))
        else:
            if leg not in LEG_FNS:
                raise ValueError(f"unknown leg {leg!r} (have {LEGS})")
            if tree is None:
                tree = Tree(root, device)
            rec.update(LEG_FNS[leg](tree))
        rec["ok"] = True
    except (AssertionError, RuntimeError, OSError, ValueError) as e:
        rec.update(ok=False, error=f"{type(e).__name__}: {e}")
    rec["wall_s"] = round(time.perf_counter() - t0, 3)
    return rec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="the fault matrix and the CI gates' real-worker legs "
                    "against the port; one JSON line a leg")
    p.add_argument("--leg", action="append", choices=(*LEGS, "all"),
                   required=True, help="a leg (repeatable; 'all' is every "
                                       "leg)")
    p.add_argument("--root", default=None,
                   help="keep the legs' trees here (default: a temporary "
                        "directory, removed at the end)")
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    legs = LEGS if "all" in args.leg else tuple(dict.fromkeys(args.leg))
    with contextlib.ExitStack() as stack:
        root = args.root or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="fault-matrix-"))
        os.makedirs(root, exist_ok=True)
        tree, failed = None, 0
        for leg in legs:
            if leg in REAL_LEGS and tree is None:
                try:
                    tree = Tree(root, args.device,
                                log=lambda m: print(m, file=sys.stderr))
                except (AssertionError, RuntimeError, OSError) as e:
                    print(json.dumps({"leg": leg, "ok": False,
                                      "error": f"the tree: {e}"}),
                          flush=True)
                    failed += 1
                    continue
            rec = run_leg(leg, root, args.device, tree)
            failed += not rec["ok"]
            print(json.dumps(rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
