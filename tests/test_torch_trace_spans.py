"""The spans inside the port's retrain, pump and host updates, on the CPU.

A cohort of two users (GaussianNB, SGD and boosted-tree host members, two
TINY vgg CNN members) on a ``FleetScheduler`` with an in-memory
``Tracer``:

- stacked (``stack_cnn=True``): each stacked ``retrain`` dispatch span
  holds users x members ``retrain.fit`` spans, each with one
  ``retrain.read`` child; a dispatch of one runs the user's own retrain,
  whose fits lie inside it under the user's iteration;
- inline (``stack_cnn=False``) and sequential (``drive_inline``): the same
  fit spans under the iteration's;
- the pump writes a ``host_wait`` span where it blocked on host steps,
  and every host update one ``member.update`` span a member, of each kind;
- ``cpu_s`` (thread CPU time) never exceeds the wall clock, and no span
  names a parent the run did not write;
- a disabled tracer records nothing and never reads the thread clock.
"""

import collections
import time

import numpy as np
import pytest
import torch

from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.al.loop import UserData
from consensus_entropy_tpu_torch.config import ALConfig, CNNConfig
from consensus_entropy_tpu_torch.config import TrainConfig
from consensus_entropy_tpu_torch.data.audio import DeviceWaveformStore
from consensus_entropy_tpu_torch.fleet import FleetScheduler, FleetUser
from consensus_entropy_tpu_torch.fleet.session import (
    UserSession,
    drive_inline,
)
from consensus_entropy_tpu_torch.models import short_cnn
from consensus_entropy_tpu_torch.models.committee import (
    CNNMember,
    Committee,
    FramePool,
)
from consensus_entropy_tpu_torch.models.gbdt import NativeGBDTMember
from consensus_entropy_tpu_torch.models.members import GNBMember, SGDMember
from consensus_entropy_tpu_torch.obs import export
from consensus_entropy_tpu_torch.obs.trace import Tracer

torch.set_num_threads(1)

TINY = CNNConfig(n_channels=4, n_mels=32, n_layers=5, input_length=8192)
TC = TrainConfig(batch_size=2)
Q, EPOCHS, RETRAIN, N_CNN, N_USERS = 3, 2, 2, 2, 2
KINDS = {"gnb", "sgd", "xgb"}


def _user(seed):
    """20 songs of 3-5 frames (F=8) around four class centres, waveforms
    of 8,300-9,500 samples (the first the longest, so every store has one
    shape), fitted host members and two fresh CNN members."""
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
    waves = {s: rng.standard_normal(
        9500 if s == 200 else int(rng.integers(8300, 9500))).astype(
        np.float32) for s in labels}
    noisy = x + rng.standard_normal(x.shape).astype(np.float32) * 4
    y = np.array([labels[s] for s in sids])
    host = [GNBMember("gnb.it_0").fit(noisy, y),
            SGDMember("sgd.it_0", seed=0).fit(noisy, y),
            NativeGBDTMember("xgb.it_0", n_estimators=4).fit(noisy, y)]
    cnn = [CNNMember(f"cnn.it_{i}", short_cnn.init_variables(
        prng.key(seed + i, "cpu"), TINY, "cpu"), TINY)
        for i in range(N_CNN)]
    committee = Committee(host, cnn, TINY, TC, device="cpu")
    store = DeviceWaveformStore(waves, TINY.input_length, "cpu")
    return committee, UserData(f"u{seed}", FramePool(x, sids), labels,
                               store=store)


def _config():
    return ALConfig(queries=Q, epochs=EPOCHS, mode="mc")


def _cohort(tmp_path, tracer, *, stack_cnn=True, plan_chunk=None):
    users = []
    for i in range(N_USERS):
        committee, data = _user(1987 + i)
        path = tmp_path / f"user{i}"
        path.mkdir()
        users.append(FleetUser(data.user_id, committee, data, str(path),
                               seed=11 + i))
    sched = FleetScheduler(_config(), retrain_epochs=RETRAIN,
                           stack_cnn=stack_cnn, plan_chunk=plan_chunk,
                           tracer=tracer, device="cpu")
    out = sched.run(users)
    assert all(r["error"] is None for r in out)
    tracer.close()
    return tracer.records


def _children(records):
    kids = collections.defaultdict(list)
    for r in records:
        kids[r["parent"]].append(r)
    return kids


def _check_fits(fits, kids):
    for fit in fits:
        names = collections.Counter(c["name"] for c in kids[fit["span"]])
        assert names == {"retrain.read": 1}
        assert fit["member"] in range(N_CNN)
        read, = kids[fit["span"]]
        # the read ends the fit
        assert fit["t0"] <= read["t0"] + 1e-6
        assert read["t0"] + read["dur_s"] <= \
            fit["t0"] + fit["dur_s"] + 1e-5
    # each user's members, one fit a member each time
    per_user = collections.Counter((f["user"], f["member"]) for f in fits)
    assert len(set(per_user.values())) == 1


def _check_common(records):
    assert export.orphan_spans(records) == []
    timed = [r for r in records if "cpu_s" in r]
    assert timed
    for r in timed:
        assert 0 <= r["cpu_s"] <= r["dur_s"] + 1e-3, r
    for r in records:
        if r["name"] in ("retrain.fit", "retrain.read", "member.update"):
            assert "cpu_s" in r, r
    by_id = {r["span"]: r for r in records}
    updates = [r for r in records if r["name"] == "member.update"]
    assert {r["kind"] for r in updates} == KINDS
    # one span a member of each user's host update, each iteration, under
    # that iteration
    assert len(updates) == len(KINDS) * N_USERS * EPOCHS
    for r in updates:
        it = by_id[r["parent"]]
        assert (it["name"], it["user"]) == ("al_iter", r["user"])


@pytest.mark.parametrize("plan_chunk", [None, N_USERS])
def test_stacked_cohort_writes_fit_wait_and_update_spans(tmp_path,
                                                         plan_chunk):
    # eager, the tiny cohort's retrains dispatch one user at a time;
    # in whole-cohort plan quanta they stack
    records = _cohort(tmp_path, Tracer(None, run_id="spans"),
                      plan_chunk=plan_chunk)
    kids = _children(records)
    by_id = {r["span"]: r for r in records}
    dispatches = [r for r in records if r["name"] == "retrain"]
    assert sum(d["batch"] for d in dispatches) == N_USERS * EPOCHS
    if plan_chunk:
        assert {d["batch"] for d in dispatches} == {plan_chunk}
    all_fits = [r for r in records if r["name"] == "retrain.fit"]
    assert len(all_fits) == N_USERS * EPOCHS * N_CNN
    for d in dispatches:
        assert d["fn"] == "cnn_retrain"
        # the fits lie inside their dispatch, one after another
        fits = [f for f in all_fits
                if d["t0"] <= f["t0"] + 1e-6
                and f["t0"] + f["dur_s"] <= d["t0"] + d["dur_s"] + 1e-5]
        assert len(fits) == d["batch"] * N_CNN
        assert len({f["user"] for f in fits}) == d["batch"]
        parents = {by_id[f["parent"]]["name"] for f in fits}
        if d["batch"] > 1:
            assert {f["parent"] for f in fits} == {d["span"]}
        else:
            assert parents == {"al_iter"}
        assert "failed" not in d
    _check_fits(all_fits, kids)
    waits = [r for r in records if r["name"] == "host_wait"]
    assert waits
    for w in waits:
        assert by_id[w["parent"]]["name"] == "run"
    _check_common(records)


def test_inline_and_sequential_retrains_write_the_same_spans(tmp_path):
    records = _cohort(tmp_path, Tracer(None, run_id="inline"),
                      stack_cnn=False)
    kids = _children(records)
    by_id = {r["span"]: r for r in records}
    assert not [r for r in records if r["name"] == "retrain"]
    fits = [r for r in records if r["name"] == "retrain.fit"]
    assert len(fits) == N_USERS * EPOCHS * N_CNN
    # a CNN committee's update and retrain stay on the generator's thread
    # when not stacked: under the user's iteration
    for f in fits:
        it = by_id[f["parent"]]
        assert (it["name"], it["user"]) == ("al_iter", f["user"])
    _check_fits(fits, kids)
    _check_common(records)

    # the sequential runner: no host step encloses them, the iteration
    # does
    committee, data = _user(2024)
    tracer = Tracer(None, run_id="sequential")
    path = tmp_path / "sequential"
    path.mkdir()
    drive_inline(UserSession(_config(), committee, data, str(path), seed=5,
                             retrain_epochs=RETRAIN, device="cpu",
                             tracer=tracer))
    tracer.close_user(str(data.user_id))
    tracer.close()
    records = tracer.records
    kids = _children(records)
    by_id = {r["span"]: r for r in records}
    fits = [r for r in records if r["name"] == "retrain.fit"]
    assert len(fits) == EPOCHS * N_CNN
    _check_fits(fits, kids)
    for r in records:
        if r["name"] in ("retrain.fit", "member.update"):
            assert by_id[r["parent"]]["name"] == "al_iter"
    assert export.orphan_spans(records) == []


def test_disabled_tracer_records_nothing_and_reads_no_thread_clock(
        tmp_path, monkeypatch):
    def boom():
        raise AssertionError("time.thread_time read with tracing off")

    monkeypatch.setattr(time, "thread_time", boom)
    tracer = Tracer(None, run_id="off", enabled=False)
    assert _cohort(tmp_path, tracer) == []
    assert tracer.cost_s == 0.0


def test_thread_cpu_is_written_only_by_the_opening_thread():
    import threading

    tracer = Tracer(None, run_id="threads")
    with tracer.span("busy", thread_cpu=True):
        c = time.thread_time()
        while time.thread_time() - c < 0.01:
            pass
    with tracer.span("plain"):
        pass
    moved = tracer.begin("moved", thread_cpu=True)
    worker = threading.Thread(target=tracer.end, args=(moved,))
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    busy, plain, other = tracer.records
    assert 0.01 <= busy["cpu_s"] <= busy["dur_s"] + 1e-3
    assert "cpu_s" not in plain and "cpu_s" not in other
