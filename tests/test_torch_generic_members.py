"""The frozen generic members (rf, svc, knn, gpc, gbc) against
scikit-learn 1.9.0 and the JAX package's ``GenericSklearnMember``.

Each kind is fitted by scikit-learn on a seeded 4-class set (240 rows, 24
features, float32 and float64; rf and gbc with 30 trees or stages, not
100), carried across by ``convert``, and its
``predict_proba`` and ``predict`` held against the estimator's and the
JAX member's on 300 other rows.  Tolerance, per kind: rf, knn, gbc and
gpc within rtol 1e-9 / atol 1e-12 (they come out bit-equal here); svc
within rtol 1e-9 / atol 1e-12 (its distances take the GEMM form where
libsvm sums exact differences, about 1e-13 relative apart); every
``predict`` equal, except knn rows whose 5th and 6th distances agree within
1e-9 relative (counted, and required to be few).  A converted JAX registry
of gnb, knn and rf members loads through the workspace and runs 2 mc
iterations alike in the port's and JAX's ``ALLoop``: the same queried
songs and F1s each iteration, the generic members unchanged by every
update."""

import copy
import json
import os
import warnings

import numpy as np
import pytest
import torch

from consensus_entropy_tpu_torch import convert
from consensus_entropy_tpu_torch.al import workspace
from consensus_entropy_tpu_torch.models import generic_members as gm
from consensus_entropy_tpu_torch.models.generic_members import GenericMember

torch.set_num_threads(1)

KINDS = ["rf", "svc", "knn", "gpc", "gbc"]
TOL = {kind: {"rtol": 1e-9, "atol": 1e-12} for kind in KINDS}
#: knn rows whose k-th and (k+1)-th distances tie within this, relative
TIE_RTOL = 1e-9
N_FIT, N_TEST, N_FEAT = 240, 300, 24
#: trees of rf and stages of gbc, cut from the registry's 100 for time
N_TREES = 30


def _estimator(kind, seed=3):
    """The JAX registry's estimator of ``kind``
    (``consensus_entropy_tpu/train/pretrain.py:49-63``), rf and gbc cut to
    N_TREES."""
    from sklearn.ensemble import (
        GradientBoostingClassifier,
        RandomForestClassifier,
    )
    from sklearn.gaussian_process import GaussianProcessClassifier
    from sklearn.gaussian_process.kernels import RBF
    from sklearn.neighbors import KNeighborsClassifier
    from sklearn.svm import SVC

    return {"rf": lambda: RandomForestClassifier(
                n_estimators=N_TREES, random_state=seed, warm_start=True),
            "svc": lambda: SVC(probability=True, random_state=seed),
            "knn": lambda: KNeighborsClassifier(),
            "gpc": lambda: GaussianProcessClassifier(
                kernel=1.0 * RBF(1.0), random_state=seed, warm_start=True),
            "gbc": lambda: GradientBoostingClassifier(
                n_estimators=N_TREES, max_depth=2, random_state=seed,
                warm_start=True)}[kind]()


def _rows(seed, dtype):
    """Overlapping 4-class rows: the probabilities are not all 0 and 1."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 0.6, (4, N_FEAT))
    y = np.arange(N_FIT) % 4
    rng.shuffle(y)
    x = rng.standard_normal((N_FIT, N_FEAT)) + centers[y]
    yt = rng.integers(0, 4, N_TEST)
    xt = rng.standard_normal((N_TEST, N_FEAT)) + centers[yt]
    return x.astype(dtype), y, xt.astype(dtype)


@pytest.fixture(scope="module")
def fitted():
    """``{(kind, dtype): (estimator, x, y, x_test)}``, fitted once."""
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # SVC(probability=True)'s notice
        for dtype in (np.float32, np.float64):
            x, y, xt = _rows(7, dtype)
            for kind in KINDS:
                out[(kind, dtype.__name__)] = (
                    _estimator(kind).fit(x, y), x, y, xt)
    return out


def _knn_ties(state, xt):
    """Rows whose 5th and 6th nearest distances agree within TIE_RTOL."""
    y = np.asarray(state["fit_X"], np.float64)
    x = np.asarray(xt, np.float64)
    d = np.sort(((x[:, None, :] - y[None]) ** 2).sum(-1), axis=1)
    k = state["n_neighbors"]
    return np.abs(d[:, k] - d[:, k - 1]) <= TIE_RTOL * d[:, k - 1]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", KINDS)
def test_member_matches_sklearn_and_jax(fitted, kind, dtype):
    from consensus_entropy_tpu.models.sklearn_members import (
        GenericSklearnMember,
    )

    est, _, _, xt = fitted[(kind, dtype)]
    member = convert.generic_from_estimator("it_0", kind, est)
    jax_member = GenericSklearnMember("it_0", kind, est)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_p, ref_y = est.predict_proba(xt), est.predict(xt)
        jax_p, jax_y = jax_member.predict_proba(xt), jax_member.predict(xt)
    p, pred = member.predict_proba(xt), member.predict(xt)
    assert p.shape == (N_TEST, 4) and p.dtype == np.float64
    np.testing.assert_allclose(p, ref_p, **TOL[kind])
    np.testing.assert_allclose(p, jax_p, **TOL[kind])
    np.testing.assert_array_equal(ref_y, jax_y)
    differ = pred != ref_y
    if kind == "knn":
        ties = _knn_ties(member.state, xt)
        assert ties.sum() <= N_TEST // 100
        differ &= ~ties
    assert not differ.any(), np.flatnonzero(differ)


def test_svc_predict_is_the_vote_not_the_probability_argmax(fitted):
    """libsvm's ``predict`` is the one-vs-one vote: on these rows it
    disagrees with the argmax of the coupled probabilities somewhere, and
    the port follows the vote, as scikit-learn does."""
    est, _, _, xt = fitted[("svc", "float64")]
    member = convert.generic_from_estimator("it_0", "svc", est)
    xs = np.vstack([xt, _rows(11, np.float64)[2], _rows(12, np.float64)[2]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = est.predict(xs)
    vote = member.predict(xs)
    argmax = np.argmax(member.predict_proba(xs), axis=1)
    np.testing.assert_array_equal(vote, ref)
    assert (vote != argmax).any()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_knn_fit_equals_sklearns_stored_state(fitted, dtype):
    est, x, y, xt = fitted[("knn", dtype)]
    member = GenericMember("it_0", "knn").fit(x, y)
    np.testing.assert_array_equal(member.state["fit_X"], est._fit_X)
    assert member.state["fit_X"].dtype == est._fit_X.dtype
    np.testing.assert_array_equal(member.state["y"], est._y)
    np.testing.assert_array_equal(member.state["classes"], est.classes_)
    assert member.state["n_neighbors"] == est.n_neighbors
    np.testing.assert_array_equal(member.predict_proba(xt),
                                  est.predict_proba(xt))


@pytest.mark.parametrize("kind", KINDS)
def test_npz_round_trip_frozen_update_and_corrupt_file(fitted, tmp_path,
                                                       kind):
    est, x, y, xt = fitted[(kind, "float32")]
    member = convert.generic_from_estimator("it_3", kind, est)
    before = member.predict_proba(xt)
    state = copy.deepcopy(member.state)
    member.update(x[:8], y[:8])  # frozen, as the JAX member
    np.testing.assert_array_equal(member.predict_proba(xt), before)
    path = str(tmp_path / f"classifier_{kind}.it_3.npz")
    member.save(path)
    back = workspace.MEMBER_TYPES[kind].load(path)
    assert (back.kind, back.name) == (kind, "it_3")
    assert workspace._member_kind(os.path.basename(path)) == kind
    for k, v in state.items():
        if not k.startswith("_"):
            np.testing.assert_array_equal(back.state[k], v)
    np.testing.assert_array_equal(back.predict_proba(xt), before)
    np.testing.assert_array_equal(back.predict(xt), member.predict(xt))
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="CRC32"):
        GenericMember.load(path)


def test_unported_settings_are_refused(fitted):
    from sklearn.neighbors import KNeighborsClassifier

    _, x, y, _ = fitted[("knn", "float64")]
    with pytest.raises(ValueError, match="uniform weights"):
        convert.generic_from_estimator(
            "it_0", "knn", KNeighborsClassifier(weights="distance").fit(x, y))
    est = fitted[("rf", "float64")][0]
    with pytest.raises(ValueError, match="not a 'knn' member"):
        convert.generic_from_estimator("it_0", "knn", est)


def test_multiclass_probability_matches_libsvm_on_a_hand_case():
    """Two rows of pairwise probabilities through the coupling: the rows
    are each a fixed point (sum 1), the uniform table stays uniform."""
    r = np.full((2, 4, 4), 0.5)
    r[1] = [[0, .9, .8, .7], [.1, 0, .6, .5], [.2, .4, 0, .3],
            [.3, .5, .7, 0]]
    p = gm.multiclass_probability(r)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-12)
    np.testing.assert_array_equal(p[0], [0.25] * 4)
    assert p[1, 0] == p[1].max()


# -- a converted registry in the AL loop ------------------------------------

EPOCHS, Q, SEED = 2, 4, 11


@pytest.fixture(scope="module")
def user_and_registry(tmp_path_factory):
    """A 40-song user (8 features, 3-7 frames a song) and a JAX registry of
    a GaussianNB, a knn and an rf member pickled by the JAX package's own
    members, converted by ``convert.registry_from_jax``."""
    from sklearn.ensemble import RandomForestClassifier
    from sklearn.neighbors import KNeighborsClassifier

    from consensus_entropy_tpu.models.sklearn_members import (
        GenericSklearnMember,
        GNBMember,
    )

    rng = np.random.default_rng(1987)
    centers = rng.standard_normal((4, 8)).astype(np.float32) * 2.5
    rows, sids, labels = [], [], {}
    for i in range(40):
        sid, c = 200 + i, int(rng.integers(0, 4))
        labels[sid] = c
        k = int(rng.integers(3, 8))
        rows.append(centers[c] + rng.standard_normal((k, 8)).astype(
            np.float32))
        sids += [sid] * k
    x = np.vstack(rows)
    fy = np.arange(200) % 4
    fx = (centers[fy] + 2.0 * rng.standard_normal((200, 8))).astype(
        np.float32)
    root = tmp_path_factory.mktemp("registry")
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    os.makedirs(jax_dir)
    GNBMember("it_0").fit(fx, fy).save(
        os.path.join(jax_dir, "classifier_gnb.it_0.pkl"))
    GenericSklearnMember("it_0", "knn", KNeighborsClassifier()).fit(
        fx, fy).save(os.path.join(jax_dir, "classifier_knn.it_0.pkl"))
    GenericSklearnMember("it_0", "rf", RandomForestClassifier(
        n_estimators=20, random_state=0, warm_start=True)).fit(
        fx, fy).save(os.path.join(jax_dir, "classifier_rf.it_0.pkl"))
    written = convert.registry_from_jax(jax_dir, port_dir)
    assert written == ["classifier_gnb.it_0.npz", "classifier_knn.it_0.npz",
                       "classifier_rf.it_0.npz"]
    return x, sids, labels, jax_dir, port_dir


def _metrics(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for _, r in sorted({r["epoch"]: r for r in recs
                                  if "event" not in r}.items())]


def test_converted_registry_runs_the_loop_like_jax(user_and_registry,
                                                   tmp_path):
    import shutil

    from consensus_entropy_tpu.al.loop import ALLoop as JaxLoop
    from consensus_entropy_tpu.al.loop import UserData as JaxUserData
    from consensus_entropy_tpu.al.workspace import (
        load_committee as jax_load,
    )
    from consensus_entropy_tpu.config import ALConfig as JaxConfig
    from consensus_entropy_tpu.models.committee import FramePool as JaxPool
    from consensus_entropy_tpu_torch.al.loop import ALLoop, UserData
    from consensus_entropy_tpu_torch.config import ALConfig
    from consensus_entropy_tpu_torch.models.committee import FramePool

    x, sids, labels, jax_dir, port_dir = user_and_registry
    jax_ws, port_ws = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(jax_dir, jax_ws)
    shutil.copytree(port_dir, port_ws)
    jax_com = jax_load(jax_ws)
    port_com = workspace.load_committee(port_ws, device="cpu")
    assert [m.kind for m in port_com.host_members] == [
        m.kind for m in jax_com.host_members] == ["gnb", "knn", "rf"]
    frozen = {m.kind: copy.deepcopy(m.state) for m in port_com.host_members
              if isinstance(m, GenericMember)}
    updates = []
    for m in port_com.host_members:
        if isinstance(m, GenericMember):
            real = m.update

            def update(X, y, m=m, real=real):
                before = m.predict_proba(x)
                real(X, y)
                updates.append(np.array_equal(m.predict_proba(x), before))
            m.update = update
    JaxLoop(JaxConfig(queries=Q, epochs=EPOCHS, mode="mc", seed=SEED)
            ).run_user(jax_com, JaxUserData("u0", JaxPool(x, sids), labels),
                       jax_ws)
    ALLoop(ALConfig(queries=Q, epochs=EPOCHS, mode="mc", seed=SEED),
           device="cpu").run_user(port_com, UserData(
               "u0", FramePool(x, sids), labels), port_ws)
    ours, theirs = _metrics(port_ws), _metrics(jax_ws)
    assert len(ours) == len(theirs) == EPOCHS + 1
    for a, b in zip(ours, theirs):
        assert a.get("queried") == b.get("queried")
        np.testing.assert_array_equal(a["f1"], b["f1"])
    assert updates and all(updates)
    for m in port_com.host_members:
        if isinstance(m, GenericMember):
            for k, v in frozen[m.kind].items():
                if not k.startswith("_"):
                    np.testing.assert_array_equal(m.state[k], v)
    # the workspace's checkpointed generic members are the registry's
    for kind in ("knn", "rf"):
        fname = f"classifier_{kind}.it_0.npz"
        saved = GenericMember.load(os.path.join(port_ws, fname))
        reg = GenericMember.load(os.path.join(port_dir, fname))
        np.testing.assert_array_equal(saved.predict_proba(x),
                                      reg.predict_proba(x))
