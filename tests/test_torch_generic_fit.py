"""The port's fits of the generic kinds (rf, gbc, svc, gpc) and of the
boosted slot's scikit-learn member against scikit-learn 1.9.0, through the
JAX package's own estimators, on the CPU.

Rows are seeded 4-class sets of 24 features (400 rows for rf and gbc,
250 for svc, 200 for gpc, whose rows are scaled to unit total variance so
that its kernel is not near the identity), in float32 and float64.
Tolerances, per kind:

- rf: the forest's nodes (feature, threshold, children, ``value``) equal,
  ``predict_proba`` equal bit for bit;
- gbc and the boosted slot: tree structure and thresholds equal, leaf
  values within rtol 1e-12, ``predict_proba`` within atol 1e-12, through
  warm-start updates that include class-deficient batches;
- svc: the support set and ``n_support`` equal, ``dual_coef``,
  ``intercept``, ``prob_a`` and ``prob_b`` within atol 1e-6, ``predict``
  equal (the kernel's dot products are summed in a plain loop where
  libsvm calls BLAS ``ddot``; they come out within about 1e-13 here);
- gpc: each binary's constant and length scale within rtol 1e-6,
  ``predict_proba`` within atol 1e-8, ``predict`` equal.

Each host core is held against its plain version bit for bit on a tiny
case, the forest under OpenMP teams of 1 and 4, and a subprocess without
scikit-learn pre-trains every kind (gbc's folds also in the process
pool) and the boosted slot.  BLAS runs on one
thread: gpc's products sum in the order the thread count gives."""

import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from consensus_entropy_tpu.models import sklearn_members as jax_members
from consensus_entropy_tpu.train import pretrain as jax_pretrain
from consensus_entropy_tpu_torch import convert, native
from consensus_entropy_tpu_torch.al import workspace
from consensus_entropy_tpu_torch.models import generic_members as gm
from consensus_entropy_tpu_torch.models import svm_fit, tree_fit
from consensus_entropy_tpu_torch.models.gbdt import NativeGBDTMember
from consensus_entropy_tpu_torch.models.generic_members import GenericMember
from consensus_entropy_tpu_torch.models.members import (
    BoostedTreesMember,
    load_member,
    make_boosted_member,
)
from tests.synth_data import build_synth_roots

torch.set_num_threads(1)

SEED = 7
N_FEAT = 24
N_ROWS = {"rf": 400, "gbc": 400, "svc": 250, "gpc": 200}
TREE_NODE_KEYS = ("offsets", "left", "right", "feature", "threshold",
                  "missing_left")


@pytest.fixture(autouse=True)
def one_blas_thread():
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _rows(kind, n, seed=0, dtype=np.float64):
    """Seeded 4-class rows (every class present), overlapping clusters."""
    rng = np.random.default_rng(seed)
    y = np.arange(n) % 4
    rng.shuffle(y)
    X = rng.standard_normal((n, N_FEAT)) + 0.6 * y[:, None] * (
        rng.standard_normal(N_FEAT) > 0)
    if kind == "gpc":
        X /= np.sqrt(X.var(axis=0).sum())
    return X.astype(dtype), y


def _sklearn_fit(kind, X, y):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        member = jax_pretrain._registry(SEED)[kind]("it_0").fit(X, y)
    return member.estimator


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["rf", "gbc", "svc", "gpc"])
def test_fit_matches_sklearn(kind, dtype):
    X, y = _rows(kind, N_ROWS[kind], dtype=dtype)
    est = _sklearn_fit(kind, X, y)
    ref = convert.generic_from_estimator("ref", kind, est).state
    ours = GenericMember("it_0", kind, seed=SEED).fit(X, y)
    st = ours.state
    Xt, _ = _rows(kind, 300, seed=1, dtype=dtype)
    want = est.predict_proba(Xt)
    got = ours.predict_proba(Xt)
    np.testing.assert_array_equal(ours.predict(Xt), est.predict(Xt))
    np.testing.assert_array_equal(st["classes"], est.classes_)
    if kind == "rf":
        for k in (*TREE_NODE_KEYS, "value"):
            np.testing.assert_array_equal(st[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(got, want)
    elif kind == "gbc":
        for k in TREE_NODE_KEYS:
            np.testing.assert_array_equal(st[k], ref[k], err_msg=k)
        np.testing.assert_allclose(st["value"], ref["value"], rtol=1e-12,
                                   atol=0)
        np.testing.assert_allclose(st["init_raw"], ref["init_raw"],
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    elif kind == "svc":
        np.testing.assert_array_equal(st["support_vectors"],
                                      est.support_vectors_)
        np.testing.assert_array_equal(st["n_support"], est._n_support)
        for k in ("dual_coef", "intercept", "prob_a", "prob_b"):
            np.testing.assert_allclose(st[k], ref[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        assert st["gamma"] == ref["gamma"]
    else:
        for k in ("constant", "length_scale"):
            np.testing.assert_allclose(st[k], ref[k], rtol=1e-6, atol=0,
                                       err_msg=k)
        # the optimizer moved every binary's kernel off its start
        assert not np.allclose(st["constant"], 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


@pytest.mark.parametrize("criterion, parallel_features, n",
                         [("gini", False, 100), ("mse", False, 100),
                          ("mse", True, 600)])
def test_tree_core_equals_its_plain_version(criterion, parallel_features, n):
    """A few trees, with tied feature values and zero-weight rows, trees
    in parallel or (600 rows: nodes past the core's 256-row threshold)
    each node's features in parallel: the core's nodes equal the Python
    builder's bit for bit."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((n, 8)).astype(np.float32)
    X[:, 2] = np.round(X[:, 2])  # ties
    X[:, 6] = np.round(X[:, 6] * 8)  # ties
    X[:, 5] = 1.5  # a constant feature
    if criterion == "gini":
        y = rng.integers(0, 4, n).astype(np.float64)
        sw = np.stack([np.bincount(rng.integers(0, n, n), minlength=n)
                       for _ in range(3)]).astype(np.float64)
        kw = {"n_classes": 4, "max_features": 3, "max_depth": 2 ** 31 - 1}
    else:
        y = rng.standard_normal((3, n))
        sw = np.ones(n)
        kw = {"max_features": 8, "max_depth": 4,
              "parallel_features": parallel_features}
    seeds = np.array([1, 12345, 2 ** 31 - 2], np.uint32)
    core = native.trees_build(X, y, sw, seeds, criterion=criterion, **kw)
    plain = native.trees_build(X, y, sw, seeds, criterion=criterion,
                               plain=True, **kw)
    assert core.keys() == plain.keys()
    for k in core:
        np.testing.assert_array_equal(core[k], plain[k], err_msg=k)
    assert (core["feature"] >= 0).sum() > 10


def test_parallel_scan_stays_linear_on_tied_columns():
    """DEAM's 260 columns, every one tied (4 values), all drawn at each
    node, as gbc draws them: the parallel feature scan on a team of 2
    builds the sequential loop's tree bit for bit, and sorts each of the
    loop's feature visits at most twice (the loop sorts each once).  A
    scan that replays every sort since the last visit without ties sorts
    the square of the features drawn (about 130 times the loop's sorts
    here)."""
    rng = np.random.default_rng(8)
    n, f = 1500, 260
    X = rng.integers(0, 4, (n, f)).astype(np.float32)
    y = rng.standard_normal(n)
    seeds = np.array([5], np.uint32)
    kw = {"criterion": "mse", "max_features": f, "max_depth": 2}
    out, counts = {}, {}
    native.limit_threads(2)
    try:
        for parallel in (False, True):
            counts[parallel] = {}
            out[parallel] = native.trees_build(
                X, y, np.ones(n), seeds, parallel_features=parallel,
                sort_counts=counts[parallel], **kw)
    finally:
        native.limit_threads(0)
    for k in out[False]:
        np.testing.assert_array_equal(out[True][k], out[False][k], err_msg=k)
    assert (out[True]["feature"] >= 0).sum() == 3
    visits = counts[False]["visits"]
    # 3 internal nodes, every feature visited at each
    assert visits == 3 * f and counts[False]["sorts"] == visits
    assert counts[True]["visits"] == visits
    # every column ties, so the replays run: more sorts than visits
    assert visits < counts[True]["sorts"] <= 2 * visits, counts


def test_forest_is_the_same_bits_under_any_team_size():
    X, y = _rows("rf", 150, seed=4)
    out = []
    for team in (1, 4):
        native.limit_threads(team)
        try:
            out.append(tree_fit.rf_fit(X, y, seed=SEED))
        finally:
            native.limit_threads(0)
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k], out[1][k], err_msg=k)


def test_svc_core_equals_its_plain_version():
    """An SVC of 60 rows: the core's model equals the numpy solver's (the
    dot products are summed left to right in both)."""
    X, y = _rows("svc", 60, seed=5)
    core = svm_fit.svc_fit(X, y, seed=SEED)
    plain = svm_fit.svc_fit(X, y, seed=SEED, plain=True)
    for k in core:
        np.testing.assert_array_equal(core[k], plain[k], err_msg=k)


def test_multinomial_gradient_core_equals_its_plain_version():
    rng = np.random.default_rng(6)
    raw = rng.standard_normal((500, 4)) * 3
    y = rng.integers(0, 4, 500).astype(np.float64)
    np.testing.assert_allclose(native.multinomial_neg_gradient(raw, y),
                               native.multinomial_neg_gradient(raw, y,
                                                               plain=True),
                               rtol=0, atol=1e-15)


def _boosted_pair(X, y):
    jax = jax_members.make_boosted_member("it_0", seed=SEED, impl="sklearn",
                                          n_estimators=12,
                                          update_estimators=4).fit(X, y)
    port = make_boosted_member("it_0", seed=SEED, impl="sklearn",
                               n_estimators=12, update_estimators=4).fit(X, y)
    return jax, port


def _same_boosted(jax, port, Xt):
    ref = convert._gbc_state(jax.estimator)
    st = port.model.state()
    for k in TREE_NODE_KEYS:
        np.testing.assert_array_equal(st[k], ref[k], err_msg=k)
    np.testing.assert_allclose(st["value"], ref["value"], rtol=1e-12, atol=0)
    np.testing.assert_allclose(port.predict_proba(Xt), jax.predict_proba(Xt),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(port.predict(Xt), jax.predict(Xt))


def test_boosted_slot_matches_jax_through_updates():
    """Fit, then three warm-start updates of 12 rows (one lacking classes
    1 and 3, padded by remembered rows), each held against JAX's
    ``BoostedTreesMember``."""
    X, y = _rows("gbc", 300, seed=7)
    Xt, _ = _rows("gbc", 200, seed=8)
    jax, port = _boosted_pair(X, y)
    _same_boosted(jax, port, Xt)
    rng = np.random.default_rng(9)
    for classes in ([0, 1, 2, 3], [0, 2], [1, 2, 3]):
        xb = rng.standard_normal((12, N_FEAT))
        yb = rng.choice(classes, 12)
        yb[:len(classes)] = classes
        jax.update(xb, yb)
        port.update(xb, yb)
        _same_boosted(jax, port, Xt)
    assert port.model.n_stages == 12 + 3 * 4


def test_boosted_pickle_converts_loads_and_updates(tmp_path):
    """A JAX pickle of the member goes through ``registry_from_jax``; the
    workspace loads the port's file as the scikit-learn boosted member, and
    its next update (lacking two classes) equals JAX's."""
    X, y = _rows("gbc", 300, seed=10)
    Xt, _ = _rows("gbc", 200, seed=11)
    jax, _ = _boosted_pair(X, y)
    src, dst = tmp_path / "jax", tmp_path / "port"
    src.mkdir()
    jax.save(str(src / "classifier_xgb.it_0.pkl"))
    assert convert.registry_from_jax(str(src), str(dst)) == [
        "classifier_xgb.it_0.npz"]
    path, _ = workspace.create_user(str(tmp_path / "users"), str(dst), 1,
                                    "mc")
    committee = workspace.load_committee(path, device="cpu")
    (member,) = committee.host_members
    assert isinstance(member, BoostedTreesMember)
    xb = np.random.default_rng(12).standard_normal((10, N_FEAT))
    yb = np.array([0, 2] * 5)
    jax.update(xb, yb)
    member.update(xb, yb)
    _same_boosted(jax, member, Xt)
    member.save(str(tmp_path / "again.npz"))
    back = load_member("xgb", str(tmp_path / "again.npz"))
    np.testing.assert_array_equal(back.predict_proba(Xt),
                                  member.predict_proba(Xt))


def test_make_boosted_member_impls():
    assert type(make_boosted_member("xgb")) is NativeGBDTMember
    assert type(make_boosted_member("xgb", impl="native")) is \
        NativeGBDTMember
    assert type(make_boosted_member("xgb", impl="sklearn")) is \
        BoostedTreesMember
    with pytest.raises(ValueError, match="no xgboost"):
        make_boosted_member("xgb", impl="xgboost")
    with pytest.raises(ValueError, match="unknown boosted impl"):
        make_boosted_member("xgb", impl="lightgbm")


_NO_SKLEARN = r"""
import sys
import time
sys.modules["sklearn"] = None
import numpy as np
from consensus_entropy_tpu_torch.models.members import make_boosted_member
from consensus_entropy_tpu_torch.train import pretrain
rng = np.random.default_rng(0)
y = np.arange(160) % 4
X = (rng.standard_normal((160, 6)) + y[:, None]).astype(np.float32)
X /= np.sqrt(X.var(axis=0).sum())
sids = np.repeat(np.arange(40), 4)
for kind in ("rf", "svc", "knn", "gpc", "gbc"):
    s = pretrain.pretrain_classic(kind, X, y, sids, cv=1,
                                  out_dir=sys.argv[1], seed=3)
    assert s["f1"]["mean"] > 0.5, (kind, s)
# the fold pool (spawned workers) fits them too, to the same metrics
seq = pretrain.pretrain_classic("gbc", X, y, sids, cv=2,
                                out_dir=sys.argv[1] + "/seq", seed=3)
par = pretrain.pretrain_classic("gbc", X, y, sids, cv=2, n_jobs=2,
                                out_dir=sys.argv[1] + "/par", seed=3)
assert par == seq, (par, seq)
m = make_boosted_member("xgb", seed=3, impl="sklearn", n_estimators=4,
                        update_estimators=2).fit(X, y)
m.update(X[:6], np.array([0, 1, 0, 1, 0, 1]))
assert m.model.n_stages == 6 and m.predict_proba(X).shape == (160, 4)
loaded = sorted(k for k, v in sys.modules.items()
                if k.startswith("sklearn") and v is not None)
assert not loaded, loaded
print("ok")
"""


def test_every_kind_pretrains_without_sklearn(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_SKLEARN, str(tmp_path)],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OPENBLAS_NUM_THREADS": "1",
             "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz")) \
        == [f"classifier_{k}.it_0.npz"
            for k in ("gbc", "gpc", "knn", "rf", "svc")]


def test_deam_classifier_gbc_writes_a_loadable_member(tmp_path, capsys):
    """``deam_classifier -m gbc -cv 1`` on the synthetic DEAM tree writes a
    member that a user workspace loads and scores with."""
    from consensus_entropy_tpu_torch.cli import deam_classifier

    roots = build_synth_roots(tmp_path, np.random.default_rng(1987))
    models = str(tmp_path / "models")
    assert deam_classifier.main(["-cv", "1", "-m", "gbc", "--models-root",
                                 models, "--deam-root", roots["deam"],
                                 "--device", "cpu"]) == 0
    assert "F1:" in capsys.readouterr().out
    from consensus_entropy_tpu_torch.config import PathsConfig
    from consensus_entropy_tpu_torch.data import deam

    pre = os.path.join(models, "pretrained")
    assert "classifier_gbc.it_0.npz" in os.listdir(pre)
    path, _ = workspace.create_user(str(tmp_path / "users"), pre, 1, "mc")
    (member,) = workspace.load_committee(path, device="cpu").host_members
    assert member.kind == "gbc" and member.state["init_raw"].shape == (4,)
    paths = PathsConfig(models_root=models, deam_root=roots["deam"])
    ann = os.path.join(roots["deam"], "annotations")
    X, y, _ = deam.training_arrays(deam.load_dataset(
        paths.deam_features_dir, os.path.join(ann, "arousal.csv"),
        os.path.join(ann, "valence.csv")))
    p = member.predict_proba(X)
    assert p.shape == (len(X), 4) and np.allclose(p.sum(axis=1), 1.0)
    assert (member.predict(X) == y).mean() > 0.5


def test_fitted_state_round_trips_through_the_member_file(tmp_path):
    """Every fitted kind saves and loads to the same predictions, and a
    pickled member (the process pool's return path) too."""
    for kind in ("rf", "gbc", "svc", "gpc"):
        X, y = _rows(kind, 120, seed=13)
        m = GenericMember("it_0", kind, seed=SEED).fit(X, y)
        path = str(tmp_path / f"classifier_{kind}.it_0.npz")
        m.save(path)
        back = load_member(kind, path)
        np.testing.assert_array_equal(back.predict_proba(X),
                                      m.predict_proba(X))
        again = pickle.loads(pickle.dumps(m))
        np.testing.assert_array_equal(gm._PROBA[kind](again.state, X),
                                      m.predict_proba(X))
