"""The port's evidence experiment against the JAX package's, on the CPU.

The synthetic users (pool, labels, hc rows and tone waveforms) are equal;
GaussianNB committees run the production loop to equal per-epoch F1
trajectories in every mode (tolerance 0); the paired t-tests, species
tests, trajectories and the analysis of a users directory are equal on
the same results; a committee with two tiny CNN members queries the same
songs and keeps its F1s within 0.05 of JAX's (float32 CNN training, C4)."""

import json
import os

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.al import evidence as jax_evidence
from consensus_entropy_tpu_torch.al import evidence

torch.set_num_threads(1)

SEEDS, EPOCHS, SONGS = (0, 1), 3, 120


@pytest.mark.parametrize("waves", [False, True])
def test_make_user_equals_jax(waves):
    a = jax_evidence.make_user(5, waves=waves, n_songs=80,
                               unfamiliar_freqs=evidence.USER_FREQS)
    b = evidence.make_user(5, waves=waves, n_songs=80,
                           unfamiliar_freqs=evidence.USER_FREQS, device="cpu")
    assert a.user_id == b.user_id and a.labels == b.labels
    np.testing.assert_array_equal(a.pool.X, b.pool.X)
    assert list(a.pool.song_ids) == list(b.pool.song_ids)
    np.testing.assert_array_equal(a.hc_rows, b.hc_rows)
    if waves:
        assert a.store.ids == b.store.ids
        np.testing.assert_array_equal(np.asarray(a.store.data),
                                      b.store.data.numpy())
        np.testing.assert_array_equal(np.asarray(a.store.lengths),
                                      b.store.lengths.numpy())
    else:
        assert b.store is None


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    kw = dict(epochs=EPOCHS, n_songs=SONGS, sgd_members=1, easy_delta=2.5,
              log=lambda s: None)
    want = jax_evidence.sweep(SEEDS, str(root / "jax"), **kw)
    got = evidence.sweep(SEEDS, str(root / "port"), device="cpu", **kw)
    return root, got, want


def test_gnb_sweep_trajectories_equal_jax(sweeps):
    _, got, want = sweeps
    assert got == want  # every mode, seed, epoch and member: tolerance 0
    assert sorted(got) == sorted(evidence.MODES)
    for by_seed in got.values():
        for per_epoch in by_seed.values():
            assert len(per_epoch) == EPOCHS + 1
            assert all(len(e) == 6 for e in per_epoch)  # 5 gnb + 1 sgd


def test_statistics_equal_jax(sweeps):
    _, got, want = sweeps
    assert evidence.paired_tests(got) == jax_evidence.paired_tests(want)
    assert (evidence.paired_tests(got, baseline="mc")
            == jax_evidence.paired_tests(want, baseline="mc"))
    slices = {"gnb": slice(0, 5), "sgd": slice(5, 6)}
    assert (evidence.species_tests(got, slices)
            == jax_evidence.species_tests(want, slices))
    assert evidence.trajectories(got) == jax_evidence.trajectories(want)


def test_analyze_users_equals_jax(sweeps, tmp_path):
    root, _, _ = sweeps
    users = str(root / "port")
    assert (evidence.analyze_users(users)
            == jax_evidence.analyze_users(users))
    # a user whose committee size differs is reported unpaired in both
    odd = tmp_path / "users"
    for uid, n in (("u1", 3), ("u2", 3), ("u3", 2)):
        for mode, m in (("mc", n), ("rand", 3)):
            d = odd / uid / mode
            d.mkdir(parents=True)
            with open(d / "metrics.jsonl", "w") as f:
                for e in range(2):
                    f.write(json.dumps({"epoch": e - 1,
                                        "f1": [0.5 + 0.01 * e] * m}) + "\n")
    got = evidence.analyze_users(str(odd))
    assert got == jax_evidence.analyze_users(str(odd))
    assert "u3" in got["tests"]["mc>rand"]["skipped"]


def test_cnn_member_run_is_jax_within_c4(tmp_path):
    kw = dict(epochs=2, n_songs=60, cnn_members=2, cnn_pretrain_epochs=2,
              cnn_retrain_epochs=1, queries=4)
    want = jax_evidence.run_one(3, "mc", str(tmp_path / "jax"), **kw)
    got = evidence.run_one(3, "mc", str(tmp_path / "port"), device="cpu",
                           **kw)
    recs = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "seed3" / "mc" / "metrics.jsonl") as f:
            recs[name] = [json.loads(x) for x in f]
    assert ([r.get("queried") for r in recs["port"]]
            == [r.get("queried") for r in recs["jax"]])
    assert len(got) == len(want) == 3
    for e, er in zip(got, want):
        assert len(e) == 7  # 2 CNN members first, then 5 GaussianNB
        np.testing.assert_allclose(e[:2], er[:2], atol=0.05)
        assert e[2:] == er[2:]
