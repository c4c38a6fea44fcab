"""The port's GaussianNB and SGD-logistic members against scikit-learn
1.9.0 and the JAX package's members, on the CPU.

Training is held to scikit-learn bit for bit (tolerance 0, float32 and
float64 data): GaussianNB ``fit``/``partial_fit`` on every fitted
attribute, SGD ``fit`` and a run of ``partial_fit`` calls on ``coef_``,
``intercept_``, ``t_`` and ``n_iter_``, class-deficient batches included,
and the pieces of SGD separately (the per-class seeds, the shuffle, one
epoch).  Predictions are held to the JAX members' host path bit for bit;
member files and ``convert.host_members_from_jax`` round trip."""

import warnings

import numpy as np
import pytest
import torch
from sklearn.linear_model import SGDClassifier
from sklearn.naive_bayes import GaussianNB
from sklearn.utils._seq_dataset import ArrayDataset32, ArrayDataset64

from consensus_entropy_tpu.models.sklearn_members import GNBMember as JaxGNB
from consensus_entropy_tpu.models.sklearn_members import SGDMember as JaxSGD
from consensus_entropy_tpu_torch import convert
from consensus_entropy_tpu_torch.models.members import (
    MAX_INT,
    GNBMember,
    SGDMember,
    shuffle_index,
)

torch.set_num_threads(1)

DTYPES = [np.float32, np.float64]
N_FEAT = 12


@pytest.fixture
def batches():
    rng = np.random.default_rng(1987)
    centers = rng.standard_normal((4, N_FEAT)) * 2

    def draw(n, classes=range(4), dtype=np.float32):
        y = rng.choice(list(classes), n)
        y[: len(list(classes))] = list(classes)  # every named class present
        x = centers[y] + rng.standard_normal((n, N_FEAT)) * 1.5
        return x.astype(dtype), y

    return draw


def _sk_sgd(seed):
    return SGDClassifier(loss="log_loss", penalty="l2", random_state=seed,
                         warm_start=True)


def _same(port, sk, attrs):
    for a in attrs:
        got, want = getattr(port, a), getattr(sk, a)
        np.testing.assert_array_equal(got, want, err_msg=a)
        assert np.asarray(got).dtype == np.asarray(want).dtype, a


GNB_ATTRS = ("classes_", "theta_", "var_", "class_count_", "class_prior_",
             "epsilon_")
SGD_ATTRS = ("classes_", "coef_", "intercept_", "t_", "n_iter_")


@pytest.mark.parametrize("dtype", DTYPES)
def test_gnb_fit_and_partial_fit_match_sklearn(batches, dtype):
    x, y = batches(200, dtype=dtype)
    sk, port = GaussianNB().fit(x, y), GNBMember().fit(x, y)
    _same(port, sk, GNB_ATTRS)
    # a run of updates, class-deficient batches among them
    for classes in ([0, 1], [3], range(4), [2]):
        xb, yb = batches(25, classes, dtype)
        sk.partial_fit(xb, yb)
        port.partial_fit(xb, yb)
        _same(port, sk, GNB_ATTRS)
        # the quirk: the smoothing is the new batch's, not the one added
        assert port.epsilon_ == port.var_smoothing * np.max(np.var(xb, 0))


def test_gnb_cold_partial_fit_and_update(batches):
    sk, port = GaussianNB(), GNBMember()
    for i, classes in enumerate(([1, 2], range(4), [0])):
        xb, yb = batches(30, classes)
        if i == 0:
            sk.partial_fit(xb, yb, classes=np.arange(4))
        else:
            sk.partial_fit(xb, yb)
        port.update(xb, yb)  # names the classes on the first call only
        _same(port, sk, GNB_ATTRS)
    with pytest.raises(ValueError, match="classes"):
        GNBMember().partial_fit(*batches(5))


def test_sgd_seeds_and_shuffle_match_sklearn():
    # the per-class seeds are drawn afresh from RandomState(random_state)
    rs = np.random.RandomState(7)
    assert rs.randint(MAX_INT, size=4).tolist() == \
        np.random.RandomState(7).randint(MAX_INT, size=4).tolist()
    # the dataset's xorshift Fisher-Yates, applied to the current order
    for n, seed in ((7, 12345), (50, 1), (33, 2 ** 31 - 5), (2, 0)):
        for dataset_type, dt in ((ArrayDataset64, np.float64),
                                 (ArrayDataset32, np.float32)):
            ds = dataset_type(np.zeros((n, 1), dt), np.zeros(n, dt),
                              np.ones(n, dt), seed=3)
            index = np.arange(n, dtype=np.intc)
            for _ in range(3):  # epochs compound
                ds._shuffle_py(seed)
                shuffle_index(index, seed)
                order = [ds._next_py()[3] for _ in range(n)]
                assert order == index.tolist()


@pytest.mark.parametrize("dtype", DTYPES)
def test_sgd_one_epoch_then_a_run_of_calls_match_sklearn(batches, dtype):
    sk, port = _sk_sgd(3), SGDMember(seed=3)
    for i, classes in enumerate((range(4), [1, 3], [0], range(4))):
        xb, yb = batches(30, classes, dtype)
        if i == 0:
            sk.partial_fit(xb, yb, classes=np.arange(4))
            port.partial_fit(xb, yb, classes=np.arange(4))
        else:
            sk.partial_fit(xb, yb)
            port.update(xb, yb)
        _same(port, sk, SGD_ATTRS)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sgd_fit_then_partial_fits_match_sklearn(batches, dtype):
    x, y = batches(300, dtype=dtype)
    sk, port = _sk_sgd(11), SGDMember(seed=11)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # ConvergenceWarning, if any
        sk.fit(x, y)
    port.fit(x, y)
    assert port.n_iter_ > 5  # the objective stop ran several epochs
    _same(port, sk, SGD_ATTRS)
    for classes in ([0, 2], range(4), [1]):
        xb, yb = batches(20, classes, dtype)
        sk.partial_fit(xb, yb)
        port.partial_fit(xb, yb)
        _same(port, sk, SGD_ATTRS)
    # a warm-started fit continues from the current weights, t_ cleared
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sk.fit(x[:100], y[:100])
    port.fit(x[:100], y[:100])
    _same(port, sk, SGD_ATTRS)


def test_sgd_refuses_data_of_the_other_dtype(batches):
    # scikit-learn's float32 and float64 variants refuse each other's
    # datasets, which the AL loop turns into a quarantine
    port = SGDMember(seed=0).fit(*batches(40, dtype=np.float64))
    with pytest.raises(TypeError):
        port.update(*batches(8, dtype=np.float32))


def test_predictions_match_the_jax_members(batches):
    x, y = batches(400)
    jg, js = JaxGNB("g").fit(x, y), JaxSGD("s", seed=4).fit(x, y)
    pg, ps = convert.host_members_from_jax([jg, js])
    xt, _ = batches(300)
    for jm, pm in ((jg, pg), (js, ps)):
        np.testing.assert_array_equal(pm.predict_proba(xt),
                                      jm.predict_proba(xt))
        np.testing.assert_array_equal(pm.predict(xt), jm.predict(xt))
        assert pm.predict_proba(xt).dtype == np.float32


def test_convert_and_member_files_round_trip(batches, tmp_path):
    x, y = batches(200)
    jg, js = JaxGNB("gnb.it_0").fit(x, y), JaxSGD("sgd.it_0", seed=2).fit(
        x, y)
    pg, ps = convert.host_members_from_jax([jg, js])
    assert (pg.name, ps.name, ps.random_state) == ("gnb.it_0", "sgd.it_0", 2)
    _same(pg, jg.estimator, GNB_ATTRS)
    _same(ps, js.estimator, SGD_ATTRS)
    for m, cls in ((pg, GNBMember), (ps, SGDMember)):
        path = str(tmp_path / f"classifier_{m.kind}.{m.name}.npz")
        m.save(path)
        back = cls.load(path)
        attrs = GNB_ATTRS if cls is GNBMember else SGD_ATTRS
        _same(back, m, attrs)
    # converted members keep training as the estimators do
    xb, yb = batches(30, [0, 3])
    jg.update(xb, yb)
    js.update(xb, yb)
    pg.update(xb, yb)
    ps.update(xb, yb)
    _same(pg, jg.estimator, GNB_ATTRS)
    _same(ps, js.estimator, SGD_ATTRS)
    with pytest.raises(ValueError, match="not ported"):
        convert.host_members_from_jax([SGDClassifier(penalty="l1").fit(x, y)])
