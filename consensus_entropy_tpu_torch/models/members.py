"""The host members GaussianNB and SGD-logistic, with their own training,
and the boosted slot's scikit-learn member.

Counterpart of ``consensus_entropy_tpu/models/sklearn_members.py:58-178``
(``GNBMember``, ``SGDMember``) and ``:244-349`` (``BoostedTreesMember``,
``make_boosted_member``).  Those wrap scikit-learn estimators; the
card machine has no scikit-learn, so here each member carries its fitted
state as numpy arrays and trains itself, reproducing scikit-learn 1.9.0:

- GaussianNB ``fit``/``partial_fit`` (``naive_bayes.py::GaussianNB.
  _partial_fit``): running means and variances per class in the input's
  float dtype, Chan-Golub-LeVeque updates, and ``epsilon_ = var_smoothing
  * max(var(X_batch))`` taken from each new batch before the old one is
  removed from ``var_``.
- SGDClassifier(loss="log_loss", penalty="l2", warm_start=True)
  ``fit``/``partial_fit``: one-vs-all binary problems, each trained by the
  ``optimal``-schedule plain SGD of ``_sgd_fast.pyx.tp`` in the weights'
  float dtype (``wscale`` decay, float products summed in double), the
  samples shuffled each epoch by the dataset's xorshift Fisher-Yates
  (``_seq_dataset.pyx.tp``, ``_random.pxd``), seeds drawn afresh from
  ``RandomState(random_state)`` on every call, ``t_`` carried across
  calls; ``fit`` stops on the training objective (``tol``,
  ``n_iter_no_change``).

Predictions follow the JAX package's host path (``native/__init__.py``):
GaussianNB posteriors in float64 from the direct form, returned as float32;
SGD float32 decision values through a saturation-safe sigmoid and the OvA
row normalisation; ``predict`` is the argmax of those values.

Member files are the port's own: ``numpy.savez`` archives holding the
arrays and a JSON header, then a CRC32 of the archive, readable without
scikit-learn (``convert.host_members_from_jax`` makes them from fitted
estimators).
"""

from __future__ import annotations

import math

import numpy as np

from consensus_entropy_tpu_torch.config import NUM_CLASSES
from consensus_entropy_tpu_torch.models.base import (
    Member,
    _read_npz,
    _require_all_classes,
    _write_npz,
)
from consensus_entropy_tpu_torch.models.gbdt import NativeGBDTMember
from consensus_entropy_tpu_torch.models.generic_members import (
    GENERIC_KINDS,
    GenericMember,
)

ALL_CLASSES = np.arange(NUM_CLASSES)
#: ``np.iinfo(np.int32).max``: the bound of scikit-learn's seed draws
MAX_INT = 2 ** 31 - 1
_MAX_DLOSS = 1e12


def _as_float_rows(X) -> np.ndarray:
    """``validate_data``'s dtype rule: float32 and float64 are kept, any
    other input becomes float64; C order."""
    X = np.asarray(X)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    if X.ndim != 2:
        raise ValueError(f"expected 2-D feature rows, got shape {X.shape}")
    return np.ascontiguousarray(X)


def _first_call(member, classes) -> bool:
    """``_check_partial_fit_first_call``: set ``classes_`` on the first
    call (which must name them); later calls must name the same ones."""
    if member.classes_ is None and classes is None:
        raise ValueError("classes must be passed on the first call to "
                         "partial_fit.")
    if classes is not None:
        classes = np.unique(np.asarray(classes))
        if member.classes_ is not None:
            if not np.array_equal(member.classes_, classes):
                raise ValueError(
                    f"`classes={classes!r}` is not the same as on last call "
                    f"to partial_fit, was: {member.classes_!r}")
            return False
        member.classes_ = classes
        return True
    return False


def _full_proba(p, classes) -> np.ndarray:
    """Expand to all NUM_CLASSES columns if the member saw fewer."""
    if p.shape[1] == NUM_CLASSES:
        return p
    full = np.zeros((p.shape[0], NUM_CLASSES), p.dtype)
    full[:, np.asarray(classes, int)] = p
    return full


#: rows per block of the GaussianNB predict: each row's sums are its own,
#: so blocking changes no bit and keeps the float64 temporaries in cache
_GNB_BLOCK = 4096


def gnb_predict_proba(X, theta, var, class_prior) -> np.ndarray:
    """GaussianNB posteriors from fitted parameters: float64 direct form,
    returned as float32 (``native.gnb_predict_proba``)."""
    theta = np.asarray(theta, np.float64)
    var = np.asarray(var, np.float64)
    log_prior = np.log(np.asarray(class_prior, np.float64))
    norm = [log_prior[k] - 0.5 * np.sum(np.log(2.0 * np.pi * var[k]))
            for k in range(theta.shape[0])]
    X = np.asarray(X, np.float32)
    out = np.empty((X.shape[0], theta.shape[0]), np.float32)

    for lo in range(0, X.shape[0], _GNB_BLOCK):
        xd = X[lo:lo + _GNB_BLOCK].astype(np.float64)
        jll = np.empty((xd.shape[0], theta.shape[0]))
        d = np.empty_like(xd)
        for k in range(theta.shape[0]):
            np.subtract(xd, theta[k], out=d)
            d **= 2
            d /= var[k]
            jll[:, k] = norm[k] - 0.5 * np.sum(d, axis=1)
        jll -= jll.max(axis=1, keepdims=True)
        p = np.exp(jll)
        out[lo:lo + _GNB_BLOCK] = p / p.sum(axis=1, keepdims=True)
    return out


def _sigmoid(x) -> np.ndarray:
    """Saturation-safe logistic: ``exp(-|x|)`` never overflows."""
    z = np.exp(-np.abs(x))
    return np.where(x >= 0, 1.0 / (1.0 + z), z / (1.0 + z))


def _ova_normalize(p) -> np.ndarray:
    """scikit-learn's OvA tail: L1-normalise rows, uniform for all-zero
    rows."""
    s = p.sum(axis=1, keepdims=True)
    zero = (s == 0.0).ravel()
    s[zero] = 1.0
    p = p / s
    p[zero] = 1.0 / p.shape[1]
    return p.astype(np.float32)


class GNBMember(Member):
    """GaussianNB (``deam_classifier.py:210-212``)."""

    kind = "gnb"

    def __init__(self, name: str = "gnb", *, var_smoothing: float = 1e-9):
        super().__init__(name)
        self.var_smoothing = var_smoothing
        self.classes_ = None
        self.theta_ = self.var_ = None
        self.class_count_ = self.class_prior_ = None
        self.epsilon_ = None

    @property
    def fitted(self) -> bool:
        return self.theta_ is not None

    def fit(self, X, y):
        y = np.asarray(y)
        _require_all_classes(y)
        self.classes_ = None
        self._partial_fit(X, y, np.unique(y))
        return self

    def partial_fit(self, X, y, classes=None):
        self._partial_fit(X, y, classes)
        return self

    def update(self, X, y):
        self.partial_fit(X, y, classes=None if self.fitted else ALL_CLASSES)

    @staticmethod
    def _update_mean_variance(n_past, mu, var, X):
        """Chan-Golub-LeVeque running mean/variance, the same numpy
        expressions (so the same dtypes and roundings) as scikit-learn's."""
        if X.shape[0] == 0:
            return mu, var
        n_new = X.shape[0]
        new_var = np.var(X, axis=0)
        new_mu = np.mean(X, axis=0)
        if n_past == 0:
            return new_mu, new_var
        n_total = float(n_past + n_new)
        total_mu = (n_new * new_mu + n_past * mu) / n_total
        old_ssd = n_past * var
        new_ssd = n_new * new_var
        total_ssd = (old_ssd + new_ssd
                     + (n_new * n_past / n_total) * (mu - new_mu) ** 2)
        return total_mu, total_ssd / n_total

    def _partial_fit(self, X, y, classes):
        first = _first_call(self, classes)
        X = _as_float_rows(X)
        y = np.asarray(y)
        if len(y) != X.shape[0]:
            raise ValueError(f"X has {X.shape[0]} rows, y has {len(y)}")
        # the smoothing removed below is this batch's, not the one that
        # was added (scikit-learn recomputes it before subtracting)
        self.epsilon_ = self.var_smoothing * np.max(np.var(X, axis=0))
        if first:
            n_classes, n_features = len(self.classes_), X.shape[1]
            self.theta_ = np.zeros((n_classes, n_features), X.dtype)
            self.var_ = np.zeros((n_classes, n_features), X.dtype)
            self.class_count_ = np.zeros(n_classes, X.dtype)
            self.class_prior_ = np.zeros(n_classes, X.dtype)
        else:
            if X.shape[1] != self.theta_.shape[1]:
                raise ValueError(
                    f"Number of features {X.shape[1]} does not match "
                    f"previous data {self.theta_.shape[1]}.")
            self.var_[:, :] -= self.epsilon_
        unique_y = np.unique(y)
        if not np.all(np.isin(unique_y, self.classes_)):
            raise ValueError(
                f"The target label(s) {unique_y[~np.isin(unique_y, self.classes_)]}"
                f" in y do not exist in the initial classes {self.classes_}")
        for y_i in unique_y:
            i = int(np.searchsorted(self.classes_, y_i))
            X_i = X[y == y_i]
            new_theta, new_sigma = self._update_mean_variance(
                self.class_count_[i], self.theta_[i, :], self.var_[i, :], X_i)
            self.theta_[i, :] = new_theta
            self.var_[i, :] = new_sigma
            self.class_count_[i] += X_i.shape[0]
        self.var_[:, :] += self.epsilon_
        self.class_prior_ = self.class_count_ / np.sum(self.class_count_)

    def predict_proba(self, X):
        p = gnb_predict_proba(X, self.theta_, self.var_, self.class_prior_)
        return _full_proba(p, self.classes_)

    def predict(self, X):
        p = gnb_predict_proba(X, self.theta_, self.var_, self.class_prior_)
        return np.asarray(self.classes_)[p.argmax(axis=1)]

    def save(self, path: str) -> None:
        _write_npz(path, {"kind": self.kind, "name": self.name,
                          "var_smoothing": self.var_smoothing},
                   {"classes_": self.classes_, "theta_": self.theta_,
                    "var_": self.var_, "class_count_": self.class_count_,
                    "class_prior_": self.class_prior_,
                    "epsilon_": np.asarray(self.epsilon_)})

    @classmethod
    def load(cls, path: str) -> "GNBMember":
        meta, a = _read_npz(path)
        obj = cls(meta["name"], var_smoothing=meta["var_smoothing"])
        obj.classes_ = a["classes_"]
        obj.theta_, obj.var_ = a["theta_"], a["var_"]
        obj.class_count_, obj.class_prior_ = (a["class_count_"],
                                              a["class_prior_"])
        obj.epsilon_ = a["epsilon_"][()]
        return obj


def _our_rand_r(state: int) -> tuple[int, int]:
    """scikit-learn's xorshift ``our_rand_r`` (``_random.pxd``): the new
    state and the draw in ``[0, 2**31)``."""
    if state == 0:
        state = 1
    state ^= (state << 13) & 0xFFFFFFFF
    state ^= state >> 17
    state ^= (state << 5) & 0xFFFFFFFF
    return state, state % (1 << 31)


def shuffle_index(index: np.ndarray, seed: int) -> None:
    """``SequentialDataset.shuffle``: Fisher-Yates in place from a copy of
    ``seed`` (the same swaps every epoch, applied to the current order)."""
    state = int(seed) & 0xFFFFFFFF
    n = len(index)
    for i in range(n - 1):
        state, r = _our_rand_r(state)
        j = i + r % (n - i)
        index[i], index[j] = index[j], index[i]


def _log1pexp(x: float) -> float:
    if x <= -37:
        return math.exp(x)
    if x <= -2:
        return math.log1p(math.exp(x))
    if x <= 18:
        return math.log(1.0 + math.exp(x))
    if x <= 33.3:
        return x + math.exp(-x)
    return x


def _dloss(y: float, p: float) -> float:
    """``cgradient_half_binomial``: expit(p) - y, in its stable form."""
    if p > -37:
        e = math.exp(-p)
        return ((1 - y) - y * e) / (1 + e)
    return math.exp(p) - y


def plain_sgd(w: np.ndarray, intercept: float, X: np.ndarray,
              y: np.ndarray, *, seed: int, max_iter: int, t: float,
              alpha: float, tol: float, n_iter_no_change: int,
              shuffle: bool = True, plain: bool = False) -> tuple[float, int]:
    """``_plain_sgd`` for the log loss, L2 penalty and the ``optimal``
    schedule, no averaging or early stopping, unit weights.  It runs in
    the host core (``native.plain_sgd``, the same arithmetic in C++);
    ``plain=True`` runs this Python loop, its plain version.

    ``w`` (float32 or float64) is updated in place, with that dtype's
    arithmetic where the Cython code has it: each product of a weight and
    a feature is rounded to the dtype and summed in double, the decay
    factor is the dtype while ``wscale`` accumulates it in double, an
    update ``w += x * (c / wscale)`` divides by a dtype copy of ``wscale``
    and adds in double.  ``y`` holds 0/1.
    Returns ``(intercept, epochs run)``.
    """
    if not plain:
        from consensus_entropy_tpu_torch import native

        return native.plain_sgd(
            w, intercept, X, y, seed=seed, max_iter=max_iter, t=t,
            alpha=alpha, tol=tol, n_iter_no_change=n_iter_no_change,
            shuffle=shuffle)
    dt = w.dtype.type
    n = X.shape[0]
    x64 = X.astype(np.float64)
    threshold = 1e-6 if w.dtype == np.float32 else 1e-9
    index = np.arange(n, dtype=np.intc)
    # ``WeightVector`` keeps ``wscale`` and the squared norm in double
    wscale = 1.0
    # only fit's stopping rule reads the objective; one epoch never stops
    track = max_iter > 1
    sq_norm = float(np.dot(w, w))
    typw = math.sqrt(1.0 / math.sqrt(alpha))
    initial_eta0 = typw / max(1.0, _dloss(1.0, -typw))
    optimal_init = 1.0 / (initial_eta0 * alpha)
    best_objective, no_improvement = math.inf, 0
    prod = np.empty_like(w)
    epoch = 0
    for epoch in range(max_iter):
        objective_sum = 0.0
        if shuffle:
            shuffle_index(index, seed)
        for i in range(n):
            k = index[i]
            yk = float(y[k])
            np.multiply(w, X[k], out=prod)
            dot = prod.cumsum(dtype=np.float64)[-1]
            p = float(dt(dot * wscale)) + intercept
            eta = 1.0 / (alpha * (optimal_init + t - 1))
            if track:
                norm = float(dt(math.sqrt(sq_norm)))
                objective_sum += _log1pexp(p) - yk * p
                objective_sum += alpha * (1.0 * 0.5 * norm ** 2)
            dloss = min(max(_dloss(yk, p), -_MAX_DLOSS), _MAX_DLOSS)
            update = -eta * dloss
            c = dt(max(0.0, 1.0 - ((1.0 - 0.0) * eta * alpha)))
            wscale *= float(c)
            sq_norm *= float(c * c)
            if wscale < threshold:
                w *= dt(wscale)
                wscale = 1.0
            if update != 0.0:
                ws = dt(wscale)  # add() divides by a dtype copy of wscale
                q = float(dt(update) / ws)
                w[:] = (w.astype(np.float64) + x64[k] * q).astype(w.dtype)
                if track:
                    np.multiply(w, w, out=prod)
                    sq_norm = (prod.cumsum(dtype=np.float64)[-1]
                               * float(ws * ws))
                intercept += update
            t += 1
        if not math.isfinite(intercept) or not np.all(np.isfinite(w)):
            raise ValueError(
                f"Floating-point under-/overflow occurred at epoch "
                f"#{epoch + 1}. Scaling input data with StandardScaler or "
                "MinMaxScaler might help.")
        if track:
            objective = objective_sum / n
            if tol > -math.inf and objective > best_objective - tol:
                no_improvement += 1
            else:
                no_improvement = 0
            best_objective = min(best_objective, objective)
            if no_improvement >= n_iter_no_change:
                break
    w *= dt(wscale)
    return intercept, epoch + 1


def _check_random_state(seed):
    """``check_random_state`` for an int seed or ``None`` (the global
    generator)."""
    return (np.random.mtrand._rand if seed is None
            else np.random.RandomState(seed))


class SGDMember(Member):
    """SGD logistic regression, L2 (``deam_classifier.py:213-218``):
    scikit-learn's ``SGDClassifier(loss="log_loss", penalty="l2",
    random_state=seed, warm_start=True)`` with its other defaults."""

    kind = "sgd"
    HYPER = ("alpha", "max_iter", "tol", "n_iter_no_change", "shuffle",
             "random_state")

    def __init__(self, name: str = "sgd", *, seed: int | None = None,
                 alpha: float = 1e-4, max_iter: int = 1000,
                 tol: float | None = 1e-3, n_iter_no_change: int = 5,
                 shuffle: bool = True):
        super().__init__(name)
        self.random_state = seed
        self.alpha, self.max_iter, self.tol = alpha, max_iter, tol
        self.n_iter_no_change, self.shuffle = n_iter_no_change, shuffle
        self.classes_ = None
        self.coef_ = self.intercept_ = None
        self.t_ = None
        self.n_iter_ = None

    @property
    def fitted(self) -> bool:
        return self.coef_ is not None

    def fit(self, X, y):
        y = np.asarray(y)
        _require_all_classes(y)
        self.classes_ = None
        self.t_ = 1.0  # fit clears the iteration count
        self._partial_fit(X, y, np.unique(y), self.max_iter)
        return self

    def partial_fit(self, X, y, classes=None):
        self._partial_fit(X, y, classes, 1)
        return self

    def update(self, X, y):
        self.partial_fit(X, y, classes=None if self.fitted else ALL_CLASSES)

    def _partial_fit(self, X, y, classes, max_iter):
        first = _first_call(self, classes)
        X = _as_float_rows(X)
        y = np.asarray(y)
        if len(y) != X.shape[0]:
            raise ValueError(f"X has {X.shape[0]} rows, y has {len(y)}")
        n_classes = len(self.classes_)
        if n_classes <= 2:
            raise ValueError("the one-vs-all member needs more than two "
                             f"classes; got {n_classes}")
        if self.coef_ is None:
            self.coef_ = np.zeros((n_classes, X.shape[1]), X.dtype)
            self.intercept_ = np.zeros(n_classes, X.dtype)
        elif X.shape[1] != self.coef_.shape[-1]:
            raise ValueError(
                f"Number of features {X.shape[1]} does not match previous "
                f"data {self.coef_.shape[-1]}.")
        elif first:
            # a warm-started fit re-casts its initial weights to the data's
            # dtype (``_allocate_parameter_mem``)
            self.coef_ = np.ascontiguousarray(self.coef_, X.dtype)
            self.intercept_ = np.asarray(self.intercept_, X.dtype)
        if self.coef_.dtype != X.dtype:
            # scikit-learn's float64 / float32 Cython variants refuse a
            # dataset of the other dtype
            raise TypeError(f"{X.dtype} rows for {self.coef_.dtype} weights")
        if self.t_ is None:
            self.t_ = 1.0
        tol = self.tol if self.tol is not None else -math.inf
        seeds = _check_random_state(self.random_state).randint(
            MAX_INT, size=n_classes)
        n_iter = 0
        for i, seed_i in enumerate(seeds):
            y_i = np.ones(y.shape, X.dtype)
            y_i[y != self.classes_[i]] = 0.0
            rs = _check_random_state(seed_i)
            rs.randint(1, np.iinfo(np.int32).max)  # the dataset's own seed
            shuffle_seed = rs.randint(MAX_INT)
            intercept, n_iter_i = plain_sgd(
                self.coef_[i], float(self.intercept_[i]), X, y_i,
                seed=shuffle_seed, max_iter=max_iter, t=self.t_,
                alpha=self.alpha, tol=tol,
                n_iter_no_change=self.n_iter_no_change, shuffle=self.shuffle)
            self.intercept_[i] = intercept
            n_iter = max(n_iter, n_iter_i)
        self.t_ += n_iter * X.shape[0]
        self.n_iter_ = n_iter

    def _logits(self, X) -> np.ndarray:
        return (np.asarray(X, np.float32) @ self.coef_.T.astype(np.float32)
                + self.intercept_.astype(np.float32))

    def predict_proba(self, X):
        return _full_proba(_ova_normalize(_sigmoid(self._logits(X))),
                           self.classes_)

    def predict(self, X):
        return np.asarray(self.classes_)[self._logits(X).argmax(axis=1)]

    def save(self, path: str) -> None:
        meta = {"kind": self.kind, "name": self.name, "t_": self.t_,
                "n_iter_": self.n_iter_,
                **{k: getattr(self, k) for k in self.HYPER}}
        _write_npz(path, meta, {"classes_": self.classes_,
                                "coef_": self.coef_,
                                "intercept_": self.intercept_})

    @classmethod
    def load(cls, path: str) -> "SGDMember":
        meta, a = _read_npz(path)
        obj = cls(meta["name"], seed=meta["random_state"],
                  **{k: meta[k] for k in cls.HYPER if k != "random_state"})
        obj.classes_, obj.coef_, obj.intercept_ = (
            a["classes_"], a["coef_"], a["intercept_"])
        obj.t_, obj.n_iter_ = meta["t_"], meta["n_iter_"]
        return obj


class BoostedTreesMember(Member):
    """The boosted slot's scikit-learn member (JAX
    ``sklearn_members.py:244-329``): ``GradientBoostingClassifier(
    max_depth=5, n_estimators=50, warm_start=True, random_state=seed)``,
    fitted by ``models/tree_fit.py::GradientBoosting``.  ``update`` boosts
    ``update_estimators`` more stages on the batch by warm start (raw
    scores recomputed on the batch's rows, the estimator's random state
    continued), the batch padded first with one remembered row of each
    class it lacks (the warm start refits the class set from the batch).
    Files carry ``impl: "sklearn"`` in their header; ``load_member``
    tells them from the native member's."""

    kind = "xgb"
    IMPL = "sklearn"

    def __init__(self, name: str = "xgb", *, max_depth: int = 5,
                 n_estimators: int = 50, update_estimators: int = 10,
                 seed: int | None = None):
        from consensus_entropy_tpu_torch.models.tree_fit import (
            GradientBoosting,
        )

        super().__init__(name)
        self.model = GradientBoosting(max_depth=max_depth,
                                      n_estimators=n_estimators,
                                      random_state=seed)
        self.update_estimators = update_estimators
        self._class_rows = {}

    def fit(self, X, y):
        X, y = np.asarray(X), np.asarray(y)
        _require_all_classes(y)
        self.model.fit(X, y)
        self._remember(X, y)
        return self

    def update(self, X, y):
        X, y = np.asarray(X), np.asarray(y)
        missing = np.setdiff1d(self.model.classes_, np.unique(y))
        if missing.size:
            Xm, ym = self._anchor_rows(missing)
            X, y = np.vstack([X, Xm]), np.concatenate([y, ym])
        self.model.n_estimators += self.update_estimators
        self.model.fit(X, y)
        self._remember(X, y)

    def _remember(self, X, y):
        for c in np.unique(y):
            self._class_rows[int(c)] = X[y == c][0]

    def _anchor_rows(self, classes):
        rows = [self._class_rows[int(c)] for c in classes]
        return np.stack(rows), np.asarray(classes)

    def predict_proba(self, X):
        from consensus_entropy_tpu_torch.models.generic_members import (
            softmax,
        )

        return _full_proba(softmax(self.model.raw(X)), self.model.classes_)

    def predict(self, X):
        return np.asarray(self.model.classes_)[
            np.argmax(self.model.raw(X), axis=1)]

    @classmethod
    def from_state(cls, st: dict) -> "BoostedTreesMember":
        """From the JAX member's pickled state (``estimator`` a fitted
        ``GradientBoostingClassifier``, read by attribute) or this class's
        own file."""
        obj = cls(st["name"], max_depth=st["max_depth"],
                  n_estimators=st["n_estimators"],
                  update_estimators=st["update_estimators"],
                  seed=st["random_state"])
        m = obj.model
        m.learning_rate = float(st["learning_rate"])
        if st.get("trees") is not None:
            m.classes_ = np.asarray(st["classes"])
            m.init_raw = np.asarray(st["init_raw"], np.float64)
            m.trees = {k: np.asarray(v) for k, v in st["trees"].items()}
            m.rng = np.random.RandomState()
            m.rng.set_state(st["rng_state"])
        obj._class_rows = {int(c): np.asarray(r)
                           for c, r in st["class_rows"].items()}
        return obj

    def save(self, path: str) -> None:
        from consensus_entropy_tpu_torch.models.tree_fit import TREE_KEYS

        m = self.model
        meta = {"kind": self.kind, "impl": self.IMPL, "name": self.name,
                "max_depth": m.max_depth, "n_estimators": m.n_estimators,
                "learning_rate": m.learning_rate,
                "update_estimators": self.update_estimators,
                "random_state": m.random_state, "fitted": m.fitted}
        arrays = {}
        if m.fitted:
            _, keys, pos, has_gauss, gauss = m.rng.get_state()
            meta.update(rng_pos=int(pos), rng_has_gauss=int(has_gauss),
                        rng_gauss=float(gauss))
            arrays.update(classes=m.classes_, init_raw=m.init_raw,
                          rng_keys=keys,
                          **{k: m.trees[k] for k in TREE_KEYS})
        labels = sorted(self._class_rows)
        arrays["class_labels"] = np.asarray(labels, np.int64)
        if labels:
            arrays["class_rows"] = np.stack([self._class_rows[c]
                                             for c in labels])
        _write_npz(path, meta, arrays)

    @classmethod
    def load(cls, path: str) -> "BoostedTreesMember":
        from consensus_entropy_tpu_torch.models.tree_fit import TREE_KEYS

        meta, a = _read_npz(path)
        if meta.get("impl") != cls.IMPL:
            raise ValueError(f"{path}: not a {cls.IMPL!r} boosted member")
        st = {k: meta[k] for k in ("name", "max_depth", "n_estimators",
                                   "learning_rate", "update_estimators",
                                   "random_state")}
        st["class_rows"] = {int(c): a["class_rows"][i]
                            for i, c in enumerate(a["class_labels"])}
        if meta["fitted"]:
            st.update(classes=a["classes"], init_raw=a["init_raw"],
                      trees={k: a[k] for k in TREE_KEYS},
                      rng_state=("MT19937", a["rng_keys"], meta["rng_pos"],
                                 meta["rng_has_gauss"], meta["rng_gauss"]))
        return cls.from_state(st)


def make_boosted_member(name: str = "xgb", seed: int = 0, *,
                        impl: str = "auto", **kw) -> Member:
    """The boosted-trees committee slot (JAX
    ``sklearn_members.py:331-349``): ``auto`` and ``native`` give the
    histogram GBDT (:class:`NativeGBDTMember`, whose trees draw nothing,
    so ``seed`` is not passed on), ``sklearn`` the warm-start
    GradientBoosting member; the port has no xgboost, so ``xgboost``
    raises."""
    if impl not in ("auto", "xgboost", "native", "sklearn"):
        raise ValueError(f"unknown boosted impl {impl!r}")
    if impl == "xgboost":
        raise ValueError("impl='xgboost': the port has no xgboost member; "
                         "use 'native' (the default) or 'sklearn'")
    if impl == "sklearn":
        return BoostedTreesMember(name, seed=seed, **kw)
    return NativeGBDTMember(name, **kw)


#: member kind -> class, for files named ``classifier_{kind}.{name}.npz``
#: (a generic kind's file names its kind in its header; an ``xgb`` file
#: may hold either boosted member, see :func:`load_member`)
MEMBER_TYPES = {"gnb": GNBMember, "sgd": SGDMember,
                "xgb": NativeGBDTMember,
                **{kind: GenericMember for kind in GENERIC_KINDS}}


def load_member(kind: str, path: str) -> Member:
    """Load a member file of ``kind``; an ``xgb`` file whose header says
    ``impl: "sklearn"`` is a :class:`BoostedTreesMember`."""
    if kind == "xgb" and _read_npz(path)[0].get("impl") == \
            BoostedTreesMember.IMPL:
        return BoostedTreesMember.load(path)
    return MEMBER_TYPES[kind].load(path)
