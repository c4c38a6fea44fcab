"""The port's closed-form members and device-member committee against
``consensus_entropy_tpu.ops.device_members`` and ``Committee(device_members
=True)`` on the CPU, within the tolerances of tests/test_device_members.py
(GNB rtol 1e-3 / atol 1e-5, from its float32 expanded form; SGD-OvA
rtol 1e-4 / atol 1e-6)."""

import numpy as np
import pytest
import torch
from sklearn.linear_model import SGDClassifier
from sklearn.naive_bayes import GaussianNB

from consensus_entropy_tpu.models.committee import Committee
from consensus_entropy_tpu.models.committee import FramePool as JaxFramePool
from consensus_entropy_tpu.models.sklearn_members import GNBMember, SGDMember
from consensus_entropy_tpu.ops import device_members as jax_members
from consensus_entropy_tpu_torch.convert import device_members_from_numpy
from consensus_entropy_tpu_torch.models.committee import (
    DeviceMemberCommittee,
    FramePool,
)
from consensus_entropy_tpu_torch.ops import device_members

torch.set_num_threads(1)

GNB_TOL = {"rtol": 1e-3, "atol": 1e-5}
SGD_TOL = {"rtol": 1e-4, "atol": 1e-6}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _stacks(rng, g, s, c=4, f=12):
    """Random member parameters in the chip-smoke recipe."""
    return (rng.normal(0, 0.5, (g, c, f)).astype(np.float32),
            rng.uniform(0.5, 2.0, (g, c, f)).astype(np.float32),
            np.log(rng.dirichlet(np.ones(c), g)).astype(np.float32),
            rng.normal(0, f ** -0.5, (s, c, f)).astype(np.float32),
            rng.normal(0, 0.1, (s, c)).astype(np.float32))


@pytest.fixture
def problem(rng):
    X = rng.standard_normal((300, 12)).astype(np.float32)
    y = rng.integers(0, 4, 300)
    return X, y


def test_gnb_and_ova_match_jax_single_and_stacked(rng, problem):
    X, _ = problem
    theta, var, lp, coef, b = _stacks(rng, 3, 2)
    got_g = device_members.gnb_probs(_t(X), _t(theta), _t(var), _t(lp))
    got_s = device_members.ova_sigmoid_probs(_t(X), _t(coef), _t(b))
    assert got_g.shape == (3, 300, 4) and got_s.shape == (2, 300, 4)
    for i in range(3):
        ref = np.asarray(jax_members.gnb_probs(X, theta[i], var[i], lp[i]))
        np.testing.assert_allclose(got_g[i].numpy(), ref, **GNB_TOL)
        one = device_members.gnb_probs(_t(X), _t(theta[i]), _t(var[i]),
                                       _t(lp[i]))
        np.testing.assert_allclose(one.numpy(), ref, **GNB_TOL)
        jll = np.asarray(jax_members.gnb_log_likelihood(X, theta[i], var[i],
                                                        lp[i]))
        np.testing.assert_allclose(
            device_members.gnb_log_likelihood(
                _t(X), _t(theta[i]), _t(var[i]), _t(lp[i])).numpy(),
            jll, rtol=1e-5, atol=1e-3)
    for i in range(2):
        ref = np.asarray(jax_members.ova_sigmoid_probs(X, coef[i], b[i]))
        np.testing.assert_allclose(got_s[i].numpy(), ref, **SGD_TOL)


def test_ova_all_zero_rows_fall_back_to_uniform():
    x = np.zeros((3, 2), np.float32)
    coef = np.zeros((4, 2), np.float32)
    b = np.full(4, -200.0, np.float32)       # sigmoid underflows to 0
    got = device_members.ova_sigmoid_probs(_t(x), _t(coef), _t(b)).numpy()
    ref = np.asarray(jax_members.ova_sigmoid_probs(x, coef, b))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, 0.25)


def test_segment_scorer_matches_jax(rng, problem):
    X, y = problem
    gnb = GaussianNB().fit(X, y)
    sgd = SGDClassifier(loss="log_loss", random_state=0).fit(X, y)
    seg = np.sort(rng.integers(0, 40, 300))
    params = (gnb.theta_[None], gnb.var_[None],
              np.log(gnb.class_prior_)[None], sgd.coef_[None],
              sgd.intercept_[None])
    ref = np.asarray(jax_members.make_device_committee_scorer(seg, 40)(
        X, *(np.asarray(p, np.float32) for p in params)))
    scorer = device_members.make_device_committee_scorer(seg, 40, "cpu")
    got = scorer(_t(X), *device_members_from_numpy(*params, device="cpu"))
    assert got.shape == ref.shape == (2, 40, 4)
    np.testing.assert_allclose(got[0].numpy(), ref[0], **GNB_TOL)
    np.testing.assert_allclose(got[1].numpy(), ref[1], **SGD_TOL)


@pytest.mark.parametrize("g,s", [(0, 0), (0, 2), (2, 0)])
def test_empty_stacks(rng, g, s):
    X = rng.standard_normal((20, 12)).astype(np.float32)
    seg = np.repeat(np.arange(4), 5)
    params = _stacks(rng, g, s)
    ref = np.asarray(jax_members.make_device_committee_scorer(seg, 4)(
        X, *params))
    got = device_members.make_device_committee_scorer(seg, 4, "cpu")(
        _t(X), *device_members_from_numpy(
            *params, device="cpu"))
    assert got.shape == ref.shape == (g + s, 4, 4)
    np.testing.assert_allclose(got.numpy(), ref, **GNB_TOL)


def test_segment_mean_over_uneven_unsorted_segments(rng):
    """Songs of 1 to 9 frames in shuffled order, one song with none (NaN,
    as in JAX); two passes are bit-equal (a fixed summation order)."""
    X = rng.standard_normal((45, 12)).astype(np.float32)
    seg = rng.permutation(np.repeat([0, 1, 2, 4, 5], [1, 9, 5, 20, 10]))
    params = _stacks(rng, 1, 1)
    ref = np.asarray(jax_members.make_device_committee_scorer(seg, 6)(
        X, *params))
    scorer = device_members.make_device_committee_scorer(seg, 6, "cpu")
    stacks = device_members_from_numpy(*params, device="cpu")
    got = scorer(_t(X), *stacks)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
    assert np.isnan(ref[:, 3]).all()
    np.testing.assert_allclose(got.numpy(), ref, **GNB_TOL)
    assert torch.equal(scorer(_t(X), *stacks).nan_to_num(),
                       got.nan_to_num())


def _fitted(X, y):
    gnbs = [GNBMember(f"gnb.it_{i}").fit(X[i::2], y[i::2]) for i in range(2)]
    sgds = [SGDMember(f"sgd.it_{i}", seed=i).fit(X, y) for i in range(2)]
    return gnbs, sgds


def test_committee_device_block_from_fitted_estimators(problem):
    X, y = problem
    frame_song = np.repeat([f"s{i:02d}" for i in range(30)], 10)
    order = np.random.default_rng(0).permutation(300)   # unsorted frames
    yf = np.repeat(y[::10], 10)
    gnbs, sgds = _fitted(X, yf)
    jax_committee = Committee(gnbs + sgds, [], device_members=True)
    jax_pool = JaxFramePool(X[order], frame_song[order])
    pool = FramePool(X[order], frame_song[order])
    assert pool.song_ids == jax_pool.song_ids
    np.testing.assert_array_equal(pool.X, jax_pool.X)

    est_g = [m.estimator for m in gnbs]
    est_s = [m.estimator for m in sgds]
    stacks = device_members_from_numpy(
        np.stack([e.theta_ for e in est_g]), np.stack([e.var_ for e in est_g]),
        np.stack([np.log(e.class_prior_) for e in est_g]),
        np.stack([e.coef_ for e in est_s]),
        np.stack([e.intercept_ for e in est_s]), device="cpu")
    committee = DeviceMemberCommittee(stacks)
    assert committee.n_members == 4
    songs = pool.song_ids[3:25]
    for pad_to in (None, 30):
        ref = np.asarray(jax_committee.pool_probs(jax_pool, None, songs, None,
                                                  pad_to=pad_to))
        got = committee.pool_probs(pool, songs, pad_to=pad_to).numpy()
        assert got.shape == ref.shape == (4, pad_to or 22, 4)
        np.testing.assert_allclose(got[:2], ref[:2], **GNB_TOL)
        np.testing.assert_allclose(got[2:], ref[2:], **SGD_TOL)
    # scorer and float32 frames are cached on the pool, per device
    cache = pool.device_cache[torch.device("cpu")]
    committee.pool_probs(pool, songs)
    assert pool.device_cache[torch.device("cpu")] is cache
    with pytest.raises(ValueError):
        committee.pool_probs(pool, songs, pad_to=5)
    with pytest.raises(ValueError):
        device_members_from_numpy(stacks.gnb_theta, stacks.gnb_var,
                                  stacks.gnb_log_prior, stacks.sgd_coef[:, :3],
                                  stacks.sgd_intercept, device="cpu")


def test_frame_pool_helpers_match_jax(rng):
    X = rng.standard_normal((60, 5)).astype(np.float32)
    frame_song = rng.permutation(np.repeat(np.arange(12), 5))
    pool, ref = FramePool(X, frame_song), JaxFramePool(X, frame_song)
    songs = [7, 2, 9]
    for a, b in zip(pool.segment_view(songs), ref.segment_view(songs)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pool.rows_for_songs(songs),
                                  ref.rows_for_songs(songs))
    assert pool.count_of(7) == ref.count_of(7) == 5
    assert pool.n_songs == ref.n_songs == 12
    np.testing.assert_allclose(pool.mean_by_song(pool.X), ref.mean_by_song(ref.X),
                               rtol=1e-6, atol=1e-7)
