"""The port's host core functions (``native/ce_host.cpp`` behind
``consensus_entropy_tpu_torch/native.py``) against the JAX package's
native build, on the CPU.

The same seeded inputs (2,000 rows, 32 features, 4 classes) go through
``linear_predict_proba`` (softmax and OvA), ``gnb_predict_proba``,
``segment_mean`` and ``row_entropy`` of both packages: the port's core
equals the JAX package's C++ build bit for bit (tolerance 0; its
``backend()`` is asserted ``'native'`` first), and each function is held
to its own plain numpy version within ``PLAIN_TOL``.  Then the edges (an
all-zero OvA row, saturated logits, zero-sum entropy rows, empty
segments) and the errors (65 classes, bad ``starts``, shape mismatches,
an unknown mode) as the JAX package's.  Last, the main path's callers:
``GNBMember.predict``/``predict_proba`` against the JAX members' on the
same fitted arrays, ``FramePool``'s segment means, and a GaussianNB +
SGD committee's ``pool_probs`` against the JAX committee's (tolerance 0,
inside the repo's rtol 1e-5 / atol 1e-6 gate)."""

import copy

import numpy as np
import pytest
import torch
from sklearn.linear_model import SGDClassifier
from sklearn.naive_bayes import GaussianNB

from consensus_entropy_tpu import native as jax_native
from consensus_entropy_tpu.models.committee import Committee as JaxCommittee
from consensus_entropy_tpu.models.committee import FramePool as JaxPool
from consensus_entropy_tpu.models.sklearn_members import GNBMember as JaxGNB
from consensus_entropy_tpu.models.sklearn_members import SGDMember as JaxSGD
from consensus_entropy_tpu_torch import convert, native
from consensus_entropy_tpu_torch.models.committee import Committee, FramePool

torch.set_num_threads(1)

N, F, C = 2000, 32, 4
#: the core against its plain version: the core rounds the linear logits
#: to float32 (the plain version keeps them in float64), and np.sum adds
#: pairwise where the core adds in order
PLAIN_TOL = {"rtol": 1e-6, "atol": 1e-7}


@pytest.fixture(scope="module")
def jax_core():
    assert jax_native.backend() == "native"
    return jax_native


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(16)
    X = (rng.standard_normal((N, F)) * 2).astype(np.float32)
    W = (rng.standard_normal((F, C)) * 0.3).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    theta = rng.standard_normal((C, F))
    var = rng.uniform(0.5, 3.0, (C, F))
    prior = rng.dirichlet(np.ones(C))
    ids = np.sort(rng.integers(0, 400, N))
    return X, W, b, theta, var, prior, ids


def _three(name, *args, **kw):
    """The port's core, the JAX package's native build and the port's
    plain version of one function."""
    return (getattr(native, name)(*args, **kw),
            getattr(jax_native, name)(*args, **kw),
            getattr(native, name)(*args, plain=True, **kw))


def _held(core, ref, plain):
    assert core.dtype == ref.dtype == plain.dtype == np.float32
    np.testing.assert_array_equal(core, ref)
    np.testing.assert_allclose(core, plain, **PLAIN_TOL)


@pytest.mark.parametrize("mode", ["softmax", "ova"])
def test_linear_predict_proba_is_the_jax_build(jax_core, data, mode):
    X, W, b = data[:3]
    core, ref, plain = _three("linear_predict_proba", X, W, b, mode)
    _held(core, ref, plain)
    np.testing.assert_allclose(core.sum(axis=1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("mode", ["softmax", "ova"])
def test_linear_edges_saturated_and_all_zero(jax_core, data, mode):
    """Integer logits of up to thousands, exact in float32 and float64
    alike (softmax rows one-hot or split by exact ties, OvA sigmoids at 0
    or 1), and rows whose every sigmoid underflows (OvA: uniform)."""
    X, W, b = data[:3]
    rng = np.random.default_rng(5)
    Xi = rng.integers(-3, 4, (400, F)).astype(np.float32)
    Wi = (rng.integers(-3, 4, (F, C)) * 20).astype(np.float32)
    bi = (rng.integers(-3, 4, C) * 10).astype(np.float32)
    core, ref, plain = _three("linear_predict_proba", Xi, Wi, bi, mode)
    np.testing.assert_array_equal(core, ref)
    assert np.isfinite(core).all()
    top = (Xi.astype(np.float64) @ Wi + bi).max(axis=1)
    # the core rounds each sigmoid to float32 before the row sum, as the
    # JAX build does: an OvA row whose every logit is -104 or less (each
    # sigmoid under half float32's least subnormal) comes out all 0 there,
    # normalised in the plain version (ROADMAP C24)
    live = top > -80.0 if mode == "ova" else np.ones_like(top, bool)
    assert live.sum() > 300
    np.testing.assert_allclose(core[live], plain[live], **PLAIN_TOL)
    np.testing.assert_allclose(core[live].sum(axis=1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(core[top <= -104.0 if mode == "ova"
                                       else ~live], 0.0)
    dead = np.full(C, -1000.0, np.float32)
    core, ref, plain = _three("linear_predict_proba", X[:50],
                              np.zeros_like(W), dead, mode)
    _held(core, ref, plain)
    np.testing.assert_array_equal(core, np.full((50, C), 0.25, np.float32))


def test_gnb_predict_proba_is_the_jax_build(jax_core, data):
    X, _, _, theta, var, prior, _ = data
    _held(*_three("gnb_predict_proba", X, theta, var, prior))


def test_segment_mean_is_the_jax_build(jax_core, data):
    X, *_, ids = data
    starts = native.segment_starts(ids)
    np.testing.assert_array_equal(starts, jax_native.segment_starts(ids))
    P = native.gnb_predict_proba(X, *data[3:6])
    core, ref, plain = _three("segment_mean", P, starts)
    _held(core, ref, plain)
    assert core.shape == (len(np.unique(ids)), C)


def test_segment_mean_of_an_empty_segment_is_zero(jax_core, data):
    P = data[0][:10, :C]
    starts = np.array([0, 0, 3, 3, 3, 7, 10, 10], np.int64)
    core, ref, plain = _three("segment_mean", P, starts)
    _held(core, ref, plain)
    np.testing.assert_array_equal(core[[0, 2, 3, 6]], 0.0)
    np.testing.assert_array_equal(core[1], P[:3].mean(axis=0,
                                                      dtype=np.float64)
                                  .astype(np.float32))


def test_row_entropy_is_the_jax_build(jax_core, data):
    P = native.gnb_predict_proba(data[0], *data[3:6])
    _held(*_three("row_entropy", P))
    # zero-sum rows, a one-hot row, rows with zeros, unnormalised rows
    edge = np.array([[0, 0, 0, 0], [0, 1, 0, 0], [0.5, 0, 0.5, 0],
                     [2, 2, 2, 2], [1e-30, 0, 0, 1]], np.float32)
    core, ref, plain = _three("row_entropy", edge)
    _held(core, ref, plain)
    np.testing.assert_allclose(core, [0, 0, np.log(2), np.log(4), 0],
                               atol=1e-6)


def _errors(fn_name, *args, **kw):
    """Each package's error on the same call: (type, message)."""
    out = []
    for pkg in (native, jax_native):
        with pytest.raises(Exception) as e:
            getattr(pkg, fn_name)(*args, **kw)
        out.append((type(e.value), str(e.value)))
    assert out[0] == out[1]
    return out[0]


def test_errors_are_the_jax_packages(jax_core, data):
    X, W, b, theta, var, prior, _ = data
    kind, msg = _errors("gnb_predict_proba", X[:5, :3], np.zeros((65, 3)),
                        np.ones((65, 3)), np.full(65, 1 / 65))
    assert kind is ValueError and "at most 64 classes" in msg
    assert _errors("gnb_predict_proba", X, theta[:, :5], var,
                   prior)[0] is ValueError
    assert _errors("linear_predict_proba", X, W[:5], b)[0] is ValueError
    assert _errors("linear_predict_proba", X, W, b, "probit")[0] is KeyError
    P = X[:10, :C]
    for starts in ([1, 10], [0, 9], [0, 6, 4, 10], [0, 11]):
        kind, msg = _errors("segment_mean", P, np.array(starts, np.int64))
        assert kind is ValueError and "non-decreasing offsets" in msg
    assert _errors("segment_starts", np.zeros((2, 2)))[0] is ValueError
    # the plain versions refuse as the core does
    with pytest.raises(ValueError, match="at most 64 classes"):
        native.gnb_predict_proba(X[:5, :3], np.zeros((65, 3)),
                                 np.ones((65, 3)), np.full(65, 1 / 65),
                                 plain=True)
    with pytest.raises(ValueError, match="non-decreasing offsets"):
        native.segment_mean(P, np.array([0, 6, 4, 10]), plain=True)


def test_the_team_size_changes_no_bit(data):
    X, W, b, theta, var, prior, ids = data
    starts = native.segment_starts(ids)
    outs = []
    for team in (1, 3):
        native.limit_threads(team)
        try:
            P = native.gnb_predict_proba(X, theta, var, prior)
            outs.append((P, native.linear_predict_proba(X, W, b, "ova"),
                         native.segment_mean(P, starts),
                         native.row_entropy(P)))
        finally:
            native.limit_threads(0)
    for a, c in zip(*outs):
        np.testing.assert_array_equal(a, c)


@pytest.fixture(scope="module")
def fitted(data):
    """Two GaussianNB and two SGD-OvA members fitted by scikit-learn on
    overlapping classes (near-ties at the class borders), as the JAX
    package's members and converted to the port's."""
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((C, F)) * 0.6
    y = rng.integers(0, C, 600)
    X = (centers[y] + rng.standard_normal((600, F))).astype(np.float32)
    jax_members = [JaxGNB("gnb.it_0").fit(X[::2], y[::2]),
                   JaxGNB("gnb.it_1").fit(X[1::2], y[1::2]),
                   JaxSGD("sgd.it_0", seed=0).fit(X, y),
                   JaxSGD("sgd.it_1", seed=3).fit(X[::-1], y[::-1])]
    assert isinstance(jax_members[0].estimator, GaussianNB)
    assert isinstance(jax_members[2].estimator, SGDClassifier)
    port = convert.host_members_from_jax(copy.deepcopy(jax_members))
    test_X = (centers[rng.integers(0, C, N)]
              + rng.standard_normal((N, F))).astype(np.float32)
    return jax_members, port, test_X


def test_gnb_member_predicts_as_the_jax_member(jax_core, fitted):
    jax_members, port, X = fitted
    for jm, pm in zip(jax_members[:2], port[:2]):
        np.testing.assert_array_equal(pm.predict(X), jm.predict(X))
        np.testing.assert_array_equal(pm.predict_proba(X),
                                      jm.predict_proba(X))
        # the member runs the core, not its plain version
        np.testing.assert_array_equal(
            pm.predict_proba(X), native.gnb_predict_proba(
                X, pm.theta_, pm.var_, pm.class_prior_))


def test_frame_pool_means_are_the_jax_pools(jax_core, data):
    X, *_, ids = data
    frame_song = np.random.default_rng(3).permutation(ids)
    P = native.gnb_predict_proba(X, *data[3:6])
    pool, ref = FramePool(P, frame_song), JaxPool(P, frame_song)
    np.testing.assert_array_equal(pool.mean_by_song(pool.X),
                                  ref.mean_by_song(ref.X))
    songs = pool.song_ids[5:40]
    rows, starts = pool.segment_view(songs)
    np.testing.assert_array_equal(
        pool.mean_over_segments(pool.X[rows], starts),
        ref.mean_over_segments(ref.X[rows], starts))
    # float64 tables keep numpy's path, empty segments included
    starts = np.array([0, 0, 4, 4, 9, 9], np.int64)
    got = FramePool.mean_over_segments(P[:9].astype(np.float64), starts)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got[[0, 2, 4]], 0.0)
    np.testing.assert_allclose(got[1], P[:4].astype(np.float64).mean(0))
    np.testing.assert_array_equal(
        FramePool.mean_over_segments(P[:9], starts),
        native.segment_mean(P[:9], starts))


def test_host_committee_pool_probs_are_the_jax_committees(jax_core,
                                                          fitted):
    jax_members, port, X = fitted
    frame_song = np.repeat(np.arange(400), N // 400)
    jpool, pool = JaxPool(X, frame_song), FramePool(X, frame_song)
    songs = pool.song_ids[17:300]
    ours = Committee(port, device="cpu")
    theirs = JaxCommittee(jax_members, [])
    for pad_to in (None, 320):
        got = ours.pool_probs(pool, songs, pad_to=pad_to)
        ref = np.asarray(theirs.pool_probs(jpool, None, songs, None,
                                           pad_to=pad_to))
        assert isinstance(got, np.ndarray)
        assert got.shape == ref.shape == (4, pad_to or len(songs), C)
        np.testing.assert_array_equal(got, ref)
