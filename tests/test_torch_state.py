"""The port's reporting, resume state, fault injection and durable writes
against the JAX package's and scikit-learn's, on the CPU.

``weighted_f1`` equals ``f1_score(average="weighted", zero_division=0)``
exactly and the report text equals ``classification_report``'s; each
package reads the other's ``al_state.json`` (the threefry key's words
included); the two-phase checkpoint recovers and rolls back as the JAX
package does; the ``CETPU_FAULTS`` grammar parses to the same rules."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from sklearn.metrics import classification_report as sk_report
from sklearn.metrics import f1_score

from consensus_entropy_tpu.al import state as jax_state
from consensus_entropy_tpu.resilience import faults as jax_faults
from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.al import state as al_state
from consensus_entropy_tpu_torch.al.reporting import (
    UserReport,
    classification_report,
    weighted_f1,
)
from consensus_entropy_tpu_torch.resilience import faults
from consensus_entropy_tpu_torch.resilience import io as dio
from consensus_entropy_tpu_torch.resilience.preemption import PreemptionGuard
from consensus_entropy_tpu_torch.resilience.retry import retry_transient

torch.set_num_threads(1)


def test_weighted_f1_and_report_text_match_sklearn():
    rng = np.random.default_rng(0)
    for case in range(200):
        n = int(rng.integers(1, 50))
        y_true = rng.integers(0, int(rng.integers(1, 5)), n).astype(np.int32)
        if case % 3:
            y_pred = rng.choice(rng.permutation(4)[:int(rng.integers(1, 5))],
                                n)
        else:  # mostly right, the common AL case
            y_pred = np.where(rng.random(n) < 0.8, y_true,
                              rng.integers(0, 4, n))
        want = f1_score(y_true, y_pred, average="weighted", zero_division=0)
        got = weighted_f1(y_true, y_pred)
        assert type(got) is float and got == want
        assert classification_report(y_true, y_pred) == \
            sk_report(y_true, y_pred, zero_division=0)


def test_user_report_files(tmp_path):
    with UserReport(str(tmp_path), "mc", now="t0") as rep:
        rep.epoch_header(-1)
        f1 = rep.model_eval("gnb.it_0", [0, 1, 2, 2], [0, 1, 1, 2])
        rep.epoch_summary(-1, [f1])
        rep.quarantine_event(0, {"member": "sgd", "reason": "x"})
        rep.epoch_summary(0, [f1, 0.5], queried=[3, "a"], pool_size=7)
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert recs[0] == {"epoch": -1, "mean_f1": f1, "f1": [f1]}
    assert recs[1]["event"] == "quarantine"
    assert recs[2]["queried"] == ["3", "a"] and recs[2]["pool_size"] == 7
    text = open(tmp_path / "mc.trial.date_t0.txt").read()
    assert "Model: gnb.it_0" in text and "weighted avg" in text


def _state(key_data, **kw):
    base = dict(next_epoch=2, trajectory=[0.5, 0.625], train_songs=["1", "b"],
                test_songs=["7"], queried=[["1"], ["b"]], key_data=key_data,
                key_dtype="uint32", mode="wmc", seed=11, queries=1,
                train_size=0.85, member_weights={"gnb": 0.75})
    base.update(kw)
    return base


def test_state_files_cross_read(tmp_path):
    key = jax.random.split(jax.random.key(11))[1]
    kd, kdt = jax_state.ALState.pack_key(key)
    port_key = prng.split(prng.key(11, "cpu"))[1]
    assert al_state.ALState.pack_key(port_key) == (kd, kdt)
    # the port writes, JAX reads (and the other way)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    al_state.ALState(**_state(kd)).save(str(a))
    jax_st = jax_state.ALState.load(str(a))
    assert jax_st == jax_state.ALState(**_state(kd))
    assert np.array_equal(jax.random.key_data(jax_st.unpack_key()),
                          jax.random.key_data(key))
    jax_state.ALState(**_state(kd)).save(str(b))
    st = al_state.ALState.load(str(b))
    assert st == al_state.ALState(**_state(kd))
    assert torch.equal(st.unpack_key(), port_key)
    assert open(a / "al_state.json").read() == open(b / "al_state.json").read()
    assert st.matches(mode="wmc", seed=11, queries=1, train_size=0.85)
    assert not st.matches(mode="mc", seed=11, queries=1, train_size=0.85)
    assert al_state.remap_songs(["b", "1"], [1, "b"]) == ["b", 1]
    with pytest.raises(ValueError, match="not in the pool"):
        al_state.remap_songs(["9"], [1])


def _gen(path, gen, members):
    """Stage members for ``gen`` and commit the state, as the loop does."""
    stage = al_state.staging_dir(str(path), gen)
    os.makedirs(stage)
    for name, body in members.items():
        (path / os.path.basename(stage) / name).write_text(body)
    al_state.ALState(**_state([0, 1], next_epoch=gen)).save(str(path))


def test_recover_and_rollback_workspace(tmp_path):
    ws = tmp_path / "ws"
    ws.mkdir()
    _gen(ws, 0, {"m.npz": "g0"})
    al_state.recover_workspace(str(ws))  # committed: promoted
    assert (ws / "m.npz").read_text() == "g0"
    _gen(ws, 1, {"m.npz": "g1"})
    al_state.recover_workspace(str(ws))
    assert (ws / "m.npz").read_text() == "g1"
    # a stage whose state never landed is discarded
    stage = al_state.staging_dir(str(ws), 2)
    os.makedirs(stage)
    (ws / "_staged_gen2" / "m.npz").write_text("torn")
    al_state.recover_workspace(str(ws))
    assert not os.path.exists(stage) and (ws / "m.npz").read_text() == "g1"
    # the last-good snapshot steps back one generation
    assert al_state.rollback_workspace(str(ws))
    assert (ws / "m.npz").read_text() == "g0"
    assert al_state.ALState.load(str(ws)).next_epoch == 0
    assert not al_state.rollback_workspace(str(ws))  # no snapshot left
    # the JAX package reads the same layout the same way
    _gen(ws, 1, {"m.npz": "g1b"})
    jax_state.recover_workspace(str(ws))
    assert (ws / "m.npz").read_text() == "g1b"
    assert jax_state.rollback_workspace(str(ws))
    assert (ws / "m.npz").read_text() == "g0"


@pytest.mark.parametrize("spec", [
    "state.save:kill@2",
    "checkpoint.write:kill@3,member.predict:corrupt@1x2",
    "member.retrain:raise@2x-1, pool.score:transient",
    "io.rename:raise,io.fsync:delay=0.5@4",
])
def test_fault_specs_parse_as_the_jax_package_does(spec):
    ours = faults.parse_spec(spec)
    theirs = jax_faults.parse_spec(spec)
    assert [(r.point, r.action, r.at, r.times, r.delay_s) for r in ours] == \
        [(r.point, r.action, r.at, r.times, r.delay_s) for r in theirs]


@pytest.mark.parametrize("bad", ["nopoint", "state.save:explode",
                                 "bogus.point:kill", "state.save:kill@0",
                                 "state.save:kill=3"])
def test_bad_fault_specs_are_refused(bad):
    with pytest.raises(ValueError):
        faults.parse_spec(bad)


def test_injection_retry_and_durable_writes(tmp_path):
    calls = []

    def flaky():
        calls.append(1)
        return faults.fire("pool.score", payload=len(calls))

    with faults.inject(faults.FaultRule("pool.score", "transient", at=1,
                                        times=2)):
        assert retry_transient(flaky, attempts=3, sleep=lambda s: None) == 3
    with faults.inject(faults.FaultRule("member.predict", "raise")), \
            pytest.raises(faults.InjectedFault):
        faults.fire("member.predict", member="m")
    with faults.inject(faults.FaultRule("state.save", "kill")), \
            pytest.raises(faults.InjectedKill):
        retry_transient(lambda: faults.fire("state.save"))  # not retried
    arr = faults.FaultInjector([faults.FaultRule(
        "member.predict", "corrupt")]).fire("member.predict",
                                            payload=np.ones((2, 2)))
    assert np.isnan(arr[0]).all() and np.isfinite(arr[1]).all()
    target = str(tmp_path / "DONE")
    with faults.inject(faults.FaultRule("io.rename", "raise")), \
            pytest.raises(OSError):
        dio.atomic_write(target, b"ok\n")
    assert os.listdir(tmp_path) == []  # no torn sibling left
    dio.atomic_write(target, b"ok\n")
    assert open(target, "rb").read() == b"ok\n"
    with PreemptionGuard() as guard:
        assert not guard.requested
        guard.request()
        assert guard.requested
