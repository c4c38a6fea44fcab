"""The port's stacked CNN device plans, ``fit_many_users`` and CNN fleet
cohorts against the per-user path and the JAX package, on the CPU, at the
TINY vgg geometry of the other CNN tests.

- The stacked forward (``CNNScorePlan``, ``CNNEvalPlan``) and the stacked
  qbdc pass (``QBDCScorePlan``) give each user the rows of its own
  ``predict_songs_cnn`` / ``qbdc_pool_probs`` call, bit for bit (tolerance
  0: the same single-user program, one user after another); a user with a
  quarantined member forms its own group, and a mixed group is refused;
  the scheduler's dispatch round serves three same-signature plans as one
  stacked dispatch.
- ``CNNTrainer.fit_many_users`` equals per-user ``fit_many`` bit for bit,
  and JAX's ``fit_many_users`` within C4's tolerances (losses rtol 1e-3 /
  atol 1e-4, weights rtol 1e-3 / atol 2e-3); a ragged cohort raises.
- A retrain plan's staging changes no member; its commit rebinds them to
  what ``retrain_cnns`` gives.
- mc and qbdc cohorts (and mc served in plan chunks of 2) of GaussianNB +
  SGD + 2 CNN members: each user's trajectory, report and state equal its
  sequential run's exactly, and its queried songs and F1s equal the JAX
  ``FleetScheduler``'s (host members tolerance 0, CNN members within 1e-6,
  as the sequential loops are held in ``test_torch_al_loop_cnn.py``)."""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from consensus_entropy_tpu.al.loop import UserData as JaxUserData
from consensus_entropy_tpu.config import ALConfig as JaxALConfig
from consensus_entropy_tpu.config import CNNConfig as JaxCNNConfig
from consensus_entropy_tpu.config import TrainConfig as JaxTrainConfig
from consensus_entropy_tpu.data.audio import DeviceWaveformStore as JaxStore
from consensus_entropy_tpu.fleet import FleetScheduler as JaxScheduler
from consensus_entropy_tpu.fleet import FleetUser as JaxUser
from consensus_entropy_tpu.models import cnn_trainer as jax_trainer
from consensus_entropy_tpu.models import short_cnn as jax_cnn
from consensus_entropy_tpu.models.committee import CNNMember as JaxCNN
from consensus_entropy_tpu.models.committee import Committee as JaxCommittee
from consensus_entropy_tpu.models.committee import FramePool as JaxPool
from consensus_entropy_tpu.models.sklearn_members import GNBMember as JaxGNB
from consensus_entropy_tpu.models.sklearn_members import SGDMember as JaxSGD
from consensus_entropy_tpu_torch import convert, prng
from consensus_entropy_tpu_torch.al.loop import ALLoop, UserData
from consensus_entropy_tpu_torch.config import ALConfig, CNNConfig
from consensus_entropy_tpu_torch.config import TrainConfig
from consensus_entropy_tpu_torch.data.audio import DeviceWaveformStore
from consensus_entropy_tpu_torch.fleet import FleetScheduler, FleetUser
from consensus_entropy_tpu_torch.labels import one_hot_np
from consensus_entropy_tpu_torch.models import committee as committee_mod
from consensus_entropy_tpu_torch.models.committee import (
    CNNMember,
    Committee,
    FramePool,
)

torch.set_num_threads(1)

TINY_KW = dict(n_channels=4, n_mels=32, n_layers=5, input_length=8192)
TINY, JAX_TINY = CNNConfig(**TINY_KW), JaxCNNConfig(**TINY_KW)
TC, JAX_TC = TrainConfig(batch_size=2), JaxTrainConfig(batch_size=2)
Q, EPOCHS, SEED, RETRAIN, QBDC_K = 3, 2, 11, 1, 4
FIT_KW = dict(batch_size=4, adam_patience=2, sgd_patience=1)
_init = jax.jit(lambda k: jax_cnn.init_variables(k, JAX_TINY))


def _user(seed):
    """20 songs: frames (F=8), labels, waveforms of 8,300-9,500 samples,
    fitted JAX host members and two JAX CNN members' variables."""
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
    host = [JaxGNB("gnb.it_0").fit(noisy, y),
            JaxSGD("sgd.it_0", seed=0).fit(noisy, y)]
    cnn = [_init(jax.random.key(seed + i)) for i in range(2)]
    return x, sids, labels, waves, host, cnn


@pytest.fixture(scope="module")
def users():
    return [_user(1987 + i) for i in range(3)]


def _committee(user):
    return Committee(
        convert.host_members_from_jax(copy.deepcopy(user[4])),
        [CNNMember(f"cnn.it_{i}",
                   convert.cnn_variables_from_jax(v, TINY, "cpu"), TINY)
         for i, v in enumerate(user[5])], TINY, TC, device="cpu")


def _store(user):
    return DeviceWaveformStore(user[3], TINY.input_length, "cpu")


def _data(user, uid):
    x, sids, labels = user[:3]
    return UserData(uid, FramePool(x, sids), labels, store=_store(user))


def _equal(a, b):
    assert a.shape == b.shape
    assert torch.equal(a, b)


def test_stacked_forward_and_qbdc_rows_are_the_per_user_calls(users):
    coms = [_committee(u) for u in users]
    stores = [_store(u) for u in users]
    songs = [list(u[2])[:17] for u in users]
    keys = [prng.key(40 + i, "cpu") for i in range(3)]
    plans = [c.cnn_score_plan(s, ids, k, pad_to=24)
             for c, s, ids, k in zip(coms, stores, songs, keys)]
    assert len({p.group_key() for p in plans}) == 1
    for p, c, s, ids, k in zip(committee_mod.run_device_plans(plans), coms,
                               stores, songs, keys):
        _equal(p, c.predict_songs_cnn(s, ids, k, pad_to=24))
    evals = [c.eval_plan(s, ids, k)
             for c, s, ids, k in zip(coms, stores, songs, keys)]
    for p, c, s, ids, k in zip(committee_mod.run_device_plans(evals), coms,
                               stores, songs, keys):
        _equal(p, c.predict_songs_cnn(s, ids, k))
    qplans = [c.qbdc_score_plan(s, ids, k, k=QBDC_K, pad_to=24)
              for c, s, ids, k in zip(coms, stores, songs, keys)]
    for p, c, s, ids, k in zip(committee_mod.run_device_plans(qplans), coms,
                               stores, songs, keys):
        _equal(p, c.qbdc_pool_probs(s, ids, k, k=QBDC_K, pad_to=24))
    # a quarantined member: that user's plan is a group of its own
    coms[1].quarantine("cnn.it_0", "test")
    plans = [c.cnn_score_plan(s, ids, k, pad_to=24)
             for c, s, ids, k in zip(coms, stores, songs, keys)]
    assert plans[1].n_members == 1
    assert plans[0].group_key() == plans[2].group_key() \
        != plans[1].group_key()
    with pytest.raises(ValueError, match="not homogeneous"):
        committee_mod.stage_device_plans(plans)
    (alone,) = committee_mod.run_device_plans([plans[1]])
    _equal(alone, coms[1].predict_songs_cnn(stores[1], songs[1], keys[1],
                                            pad_to=24))
    assert alone.shape[0] == 1
    # no plan where the per-user path must run: no store, no song
    assert coms[0].cnn_score_plan(None, songs[0], keys[0], pad_to=24) is None
    assert coms[0].eval_plan(stores[0], [], keys[0]) is None


def _fit_users(users, n_users, key0=5):
    out = []
    for i in range(n_users):
        x, sids, labels, waves, host, cnn = users[i]
        ids = list(labels)
        y = one_hot_np([labels[s] for s in ids])
        out.append((waves, ids[:6], y[:6], ids[6:10], y[6:10], cnn,
                    key0 + i))
    return out


def test_fit_many_users_is_per_user_fit_many_and_jax(users):
    """At ``test_torch_cnn_trainer.py``'s training geometry (6 train and 4
    test songs, batch 4), where C4's tolerances were set; two adam
    epochs."""
    cohort = _fit_users(users, 2)
    trainer = committee_mod.CNNTrainer(TINY, TrainConfig(**FIT_KW))
    port_users = [dict(variables_list=[convert.cnn_variables_from_jax(
                           v, TINY, "cpu") for v in cnn],
                       store=DeviceWaveformStore(w, 8192, "cpu"),
                       train_ids=tr, train_y=ytr, test_ids=te, test_y=yte,
                       key=prng.key(k, "cpu"))
                  for w, tr, ytr, te, yte, cnn, k in cohort]
    got = trainer.fit_many_users(port_users, n_epochs=2)
    for u, (best, hist) in zip(port_users, got):
        rbest, rhist = trainer.fit_many(
            u["variables_list"], u["store"], u["train_ids"], u["train_y"],
            u["test_ids"], u["test_y"], u["key"], n_epochs=2)
        assert hist == rhist
        for b, rb in zip(best, rbest):
            assert b.keys() == rb.keys()
            for name in b:
                _equal(b[name], rb[name])
    jax_got = jax_trainer.CNNTrainer(
        JAX_TINY, JaxTrainConfig(**FIT_KW)).fit_many_users(
        [dict(variables_list=cnn, store=JaxStore(w, 8192), train_ids=tr,
              train_y=ytr, test_ids=te, test_y=yte, key=jax.random.key(k))
         for w, tr, ytr, te, yte, cnn, k in cohort], n_epochs=2)
    for (best, hist), (jbest, jhist) in zip(got, jax_got):
        for h, jh in zip(hist, jhist):
            assert [e["improved"] for e in h] == [e["improved"] for e in jh]
            for e, je in zip(h, jh):
                for k in ("train_loss", "val_loss", "val_f1"):
                    np.testing.assert_allclose(e[k], je[k], rtol=1e-3,
                                               atol=1e-4, err_msg=k)
        for b, jb in zip(best, jbest):
            ref = convert.cnn_variables_from_jax(jb, TINY, "cpu")
            for name, t in b.items():
                np.testing.assert_allclose(t.numpy(), ref[name].numpy(),
                                           rtol=1e-3, atol=2e-3,
                                           err_msg=name)
    ragged = [dict(u) for u in port_users]
    ragged[1]["variables_list"] = ragged[1]["variables_list"][:1]
    with pytest.raises(ValueError, match="not homogeneous"):
        trainer.fit_many_users(ragged, n_epochs=1)
    ragged = [dict(u) for u in port_users]
    ragged[1]["train_ids"] = ragged[1]["train_ids"][:5]
    ragged[1]["train_y"] = ragged[1]["train_y"][:5]
    with pytest.raises(ValueError, match="not homogeneous"):
        trainer.fit_many_users(ragged, n_epochs=1)


def test_retrain_plan_staging_is_pure_and_commit_rebinds(users):
    cohort = _fit_users(users, 2)
    coms = [_committee(users[i]) for i in range(2)]
    refs = [_committee(users[i]) for i in range(2)]
    plans = []
    for c, (w, tr, ytr, te, yte, _, k) in zip(coms, cohort):
        plans.append(c.retrain_plan(DeviceWaveformStore(w, 8192, "cpu"),
                                    tr, ytr, te, yte, prng.key(k, "cpu"),
                                    n_epochs=2))
    before = [[m.variables for m in c.cnn_members] for c in coms]
    computed = committee_mod.stage_device_plans(plans)
    for c, vs in zip(coms, before):  # staging rebinds nothing
        assert all(m.variables is v for m, v in zip(c.cnn_members, vs))
    histories = committee_mod.commit_device_plans(plans, computed)
    for c, r, (w, tr, ytr, te, yte, _, k), h in zip(coms, refs, cohort,
                                                    histories):
        assert r.retrain_cnns(DeviceWaveformStore(w, 8192, "cpu"), tr, ytr,
                              te, yte, prng.key(k, "cpu"), n_epochs=2) == h
        for m, rm in zip(c.cnn_members, r.cnn_members):
            improved = any(e["improved"] for e in h[c.cnn_members.index(m)])
            assert (m.variables is not m_before(before, coms, m)) == improved
            for name, t in m.variables.items():
                _equal(t, rm.variables[name])


def m_before(before, coms, member):
    for c, vs in zip(coms, before):
        if member in c.cnn_members:
            return vs[c.cnn_members.index(member)]
    raise KeyError(member)


def _jsonl(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("mode, chunk", [("mc", None), ("qbdc", None),
                                         ("mc", 2)],
                         ids=["mc", "qbdc", "mc-chunk2"])
def test_cnn_cohort_matches_sequential_and_the_jax_fleet(users, tmp_path,
                                                         mode, chunk):
    cfg = ALConfig(queries=Q, epochs=EPOCHS, mode=mode, seed=SEED,
                   qbdc_k=QBDC_K, ckpt_dtype="float32")
    pad = max(len(u[2]) for u in users)
    seq, entries = [], []
    for i, u in enumerate(users):
        for kind in ("seq", "fleet"):
            (tmp_path / f"{kind}_u{i}").mkdir()
        seq.append(ALLoop(cfg, retrain_epochs=RETRAIN, pad_pool_to=pad,
                          device="cpu").run_user(
            _committee(u), _data(u, f"u{i}"), str(tmp_path / f"seq_u{i}")))
        entries.append(FleetUser(f"u{i}", _committee(u), _data(u, f"u{i}"),
                                 str(tmp_path / f"fleet_u{i}"), seed=SEED))
    sched = FleetScheduler(cfg, retrain_epochs=RETRAIN, plan_chunk=chunk,
                           device="cpu")
    recs = sched.run(entries)
    for i, (s, r) in enumerate(zip(seq, recs)):
        assert r["error"] is None, r
        assert r["result"]["trajectory"] == s["trajectory"]
        assert _jsonl(tmp_path / f"fleet_u{i}") == _jsonl(
            tmp_path / f"seq_u{i}")
    summary = sched.report.summary(cohort=len(users))
    assert "dispatch_failures" not in summary
    # every CNN device step was graded as a plan dispatch (how many users
    # shared one depends on host timing: the stacked path itself is held
    # by the plan tests above)
    cnn = summary["cnn"]
    assert set(cnn) >= {"cnn_retrain", "cnn_eval",
                        "qbdc_probs" if mode == "qbdc" else "cnn_probs"}
    assert 1.0 <= cnn["mean_device_batch"] <= len(users)
    if chunk:
        assert all(d["batch"] <= chunk for d in sched.report.dispatches
                   if d["fn"] in ("cnn_probs", "cnn_retrain", "cnn_eval"))
        return
    jax_entries = []
    for i, u in enumerate(users):
        x, sids, labels, waves, host, cnn_vars = u
        path = tmp_path / f"jax_u{i}"
        path.mkdir()
        jax_entries.append(JaxUser(
            f"u{i}", JaxCommittee(
                copy.deepcopy(host),
                [JaxCNN(f"cnn.it_{j}", v, JAX_TINY, JAX_TC)
                 for j, v in enumerate(cnn_vars)], JAX_TINY, JAX_TC),
            JaxUserData(f"u{i}", JaxPool(x, sids), labels,
                        store=JaxStore(waves, TINY.input_length)),
            str(path), seed=SEED))
    jax_recs = JaxScheduler(
        JaxALConfig(queries=Q, epochs=EPOCHS, mode=mode, seed=SEED,
                    qbdc_k=QBDC_K, ckpt_dtype="float32"),
        retrain_epochs=RETRAIN).run(jax_entries)
    for i, j in enumerate(jax_recs):
        assert j["error"] is None
        ours = [e for e in _jsonl(tmp_path / f"fleet_u{i}")
                if "event" not in e]
        theirs = [e for e in _jsonl(tmp_path / f"jax_u{i}")
                  if "event" not in e]
        assert len(ours) == len(theirs) == EPOCHS + 1
        for a, b in zip(ours, theirs):
            assert a.get("queried") == b.get("queried")
            assert a["f1"][2:] == b["f1"][2:]  # host members: tolerance 0
            np.testing.assert_allclose(a["f1"][:2], b["f1"][:2], atol=1e-6)


def test_one_round_of_plans_is_one_stacked_dispatch(users):
    """The scheduler's dispatch round without host timing: three sessions'
    same-signature CNN plans are ONE stacked dispatch whose rows are their
    single calls; a plan of another signature is served by its own
    ``single`` closure."""
    import types

    from consensus_entropy_tpu_torch.fleet.session import DeviceStep

    coms = [_committee(u) for u in users]
    stores = [_store(u) for u in users]
    songs = [list(u[2])[:12] for u in users]
    keys = [prng.key(60 + i, "cpu") for i in range(3)]
    sched = FleetScheduler(ALConfig(queries=Q), device="cpu")
    sched.open(4)
    work = []
    try:
        for i, (c, s, ids, k) in enumerate(zip(coms, stores, songs, keys)):
            plan = c.cnn_score_plan(s, ids, k, pad_to=16)
            work.append((i, DeviceStep(
                types.SimpleNamespace(acq=types.SimpleNamespace(n_pad=16)),
                plan, lambda: None, plan.fn_key)))
        odd = coms[0].eval_plan(stores[0], songs[0], keys[0])
        work.append((3, DeviceStep(
            types.SimpleNamespace(acq=types.SimpleNamespace(n_pad=16)), odd,
            lambda: coms[0].predict_songs_cnn(stores[0], songs[0], keys[0]),
            odd.fn_key)))
        states = [types.SimpleNamespace(
            n_pad=16, entry=types.SimpleNamespace(user_id=f"u{i}"))
            for i, _ in work]
        rows = sched._dispatch_scores(
            [(st, step) for st, (_, step) in zip(states, work)])
    finally:
        sched.close()
    got = {id(st): res for st, res in rows}
    for st, (i, step) in zip(states, work):
        want = (coms[i].predict_songs_cnn(stores[i], songs[i], keys[i],
                                          pad_to=16) if i < 3 else
                coms[0].predict_songs_cnn(stores[0], songs[0], keys[0]))
        _equal(got[id(st)], want)
    assert sorted((d["fn"], d["batch"]) for d in sched.report.dispatches) \
        == [("cnn_eval", 1), ("cnn_probs", 3)]
