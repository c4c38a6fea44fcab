"""The frozen generic members: random forest, RBF SVC, k-nearest
neighbours, Gaussian-process and gradient-boosting classifiers.

Counterpart of ``consensus_entropy_tpu/models/sklearn_members.py:106-132``
(``GenericSklearnMember``).  The reference's registry can pre-train these
kinds (``deam_classifier.py:201-225``) and its AL dispatch
(``amg_test.py:503-509``) never retrains them, so in a committee they only
predict.  The JAX member wraps the fitted scikit-learn estimator; the card
machine has no scikit-learn, so here a member carries the estimator's
fitted arrays and predicts from them on the host (numpy, scipy, and torch
on the CPU for knn's search), reproducing scikit-learn 1.9.0's
``predict_proba`` and ``predict``:

- ``knn`` (``KNeighborsClassifier()``: k = 5, uniform weights, Euclidean):
  the brute-force search of ``_argkmin.pyx.tp`` ranks every training row
  by ``|x|^2 - 2 x.y + |y|^2`` in float64 (float32 rows upcast), clamped at
  0, keeping the lower index among equal distances, as its heap does; the
  probability is each class's count over k, ``predict`` its argmax (the
  smallest class on a tie).  Rows whose k-th and (k+1)-th distances agree
  within rounding may pick either neighbour.  Below 16 features
  scikit-learn searches a k-d tree instead: the same neighbours, its own
  order among exact ties.  ``fit`` stores the rows, as scikit-learn does.
- ``rf`` (``RandomForestClassifier``): rows cast to float32 and compared
  in double with each node's float64 threshold (NaN follows
  ``missing_go_to_left``); each tree's leaf holds class fractions
  (``tree_.value``), summed in tree order in float64 and divided by the
  number of trees; ``predict`` is the argmax.
- ``gbc`` (``GradientBoostingClassifier``, multi-class): the raw score
  starts from ``init_``'s prior in link space and adds ``learning_rate``
  times a leaf value for every stage and class, rows in float32;
  the probability is ``extmath.softmax`` of it, ``predict`` its argmax.
- ``svc`` (``SVC(probability=True)``, RBF): libsvm's one-vs-one decision
  values from the support vectors (grouped by class), ``_dual_coef_``, and
  ``rho = -_intercept_``; the pairwise probabilities are
  ``sigmoid_predict`` with ``probA_``/``probB_`` clamped to [1e-7, 1-1e-7],
  coupled by ``multiclass_probability`` (at most 100 sweeps, eps 0.005/k);
  ``predict`` is the one-vs-one vote (ties to the first class), not the
  argmax of those probabilities.  The squared distances take the GEMM
  form, where libsvm sums exact differences: values agree to rounding.
- ``gpc`` (``GaussianProcessClassifier(1.0 * RBF(1.0))``, one-vs-rest over
  binary Laplace estimators): each estimator's latent mean and variance
  from ``X_train_``, ``y_train_``, ``pi_``, ``W_sr_``, ``L_`` and its fitted
  constant and length scale (``scipy.spatial.distance.cdist``, once per
  distinct length scale; a triangular solve of ``L_``), the probit
  integral through ``LAMBDAS``/``COEFS`` and ``scipy.special.erf``; the
  rows normalised by their sum;
  ``predict`` the first class of largest binary probability.

Every kind also fits without scikit-learn, reproducing the estimator
the JAX registry makes (``consensus_entropy_tpu/train/pretrain.py:49-63``)
and its fitted arrays: ``knn`` stores its rows; ``rf`` and ``gbc`` build
scikit-learn's trees in the host core (``models/tree_fit.py``,
``native/ce_tree.cpp``); ``svc`` trains libsvm's solver there
(``models/svm_fit.py``, ``native/ce_svm.cpp``); ``gpc`` runs the Laplace
fit in numpy and scipy (``models/gpc_fit.py``).

Member files are the port's ``.npz`` with its CRC32 trailer
(``models/base.py``); the pre-trainer writes them from these fits, and
``convert`` makes them from the JAX package's pickles, where
scikit-learn is installed.
"""

from __future__ import annotations

import numpy as np

from consensus_entropy_tpu_torch.config import NUM_CLASSES
from consensus_entropy_tpu_torch.models.base import (
    Member,
    _read_npz,
    _require_all_classes,
    _write_npz,
)

#: the registry's scikit-learn kinds (JAX ``train/pretrain.py:49-63``)
GENERIC_KINDS = ("rf", "svc", "knn", "gpc", "gbc")

#: ``KNeighborsClassifier()``'s k
KNN_NEIGHBORS = 5
#: float64 distance entries per block of the brute-force search
_KNN_BLOCK = 1 << 24
#: libsvm's probability clamp and coupling's sweep cap
_SVM_MIN_PROB = 1e-7
_SVM_MAX_ITER = 100
#: ``sklearn/gaussian_process/_gpc.py``'s probit approximation
_GPC_LAMBDAS = np.array([0.41, 0.4, 0.37, 0.44, 0.39])[:, np.newaxis]
_GPC_COEFS = np.array([-1854.8214151, 3516.89893646, 221.29346712,
                       128.12323805, -2010.49422654])[:, np.newaxis]


def _rows(X, dtype) -> np.ndarray:
    X = np.ascontiguousarray(X, dtype)
    if X.ndim != 2:
        raise ValueError(f"expected 2-D feature rows, got shape {X.shape}")
    return X


def _sq_norms(X: np.ndarray) -> np.ndarray:
    """float64 squared row norms, one dot product a row (BLAS ``ddot``, as
    ``_sqeuclidean_row_norms64`` takes them)."""
    return np.fromiter((r @ r for r in X), np.float64, X.shape[0])


# -- knn ------------------------------------------------------------------


def knn_fit(X, y, n_neighbors: int = KNN_NEIGHBORS) -> dict:
    """``KNeighborsClassifier.fit``'s stored state: the rows in their float
    dtype (C order), the labels as class indices, the classes."""
    X = np.asarray(X)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    classes, y_idx = np.unique(np.asarray(y), return_inverse=True)
    return {"fit_X": _rows(X, X.dtype), "y": y_idx.astype(np.intp),
            "classes": classes, "n_neighbors": int(n_neighbors)}


def knn_neighbors(state: dict, X) -> np.ndarray:
    """``(n, k)`` training-row indices of each row's k nearest, by the
    float64 GEMM-form distance, the lower index first among equals.  The
    product and the k+1 smallest of each row are taken with torch on the
    CPU (its threads); a row whose k-th and (k+1)-th distances are equal
    is ranked exactly by (distance, index) in numpy."""
    import torch

    Y = _rows(state["fit_X"], np.float64)
    X = _rows(X, np.float64)
    k = int(state["n_neighbors"])
    y_norm = state.get("_y_norm")
    if y_norm is None:
        y_norm = state["_y_norm"] = _sq_norms(Y)
    x_norm = torch.from_numpy(_sq_norms(X))
    y_t, y_norm_t = torch.from_numpy(Y), torch.from_numpy(y_norm)
    out = np.empty((X.shape[0], k), np.intp)
    step = max(1, _KNN_BLOCK // max(Y.shape[0], 1))
    take = min(k + 1, Y.shape[0])
    for lo in range(0, X.shape[0], step):
        hi = min(lo + step, X.shape[0])
        d = torch.from_numpy(X[lo:hi]) @ y_t.T
        d.mul_(-2.0).add_(x_norm[lo:hi, None]).add_(y_norm_t[None, :])
        d.clamp_(min=0.0)
        vals, idx = torch.topk(d, take, dim=1, largest=False, sorted=True)
        vals, idx = vals.numpy(), idx.numpy()
        out[lo:hi] = idx[:, :k]
        if take > k:
            for i in np.flatnonzero(vals[:, k - 1] == vals[:, k]):
                # a tie at the k-th distance: the heap keeps the earlier
                # rows, so rank by (distance, index)
                row = d[i].numpy()
                cand = np.flatnonzero(row <= vals[i, k - 1])
                out[lo + i] = cand[np.lexsort((cand, row[cand]))[:k]]
    return out


def knn_predict_proba(state: dict, X) -> np.ndarray:
    neigh = knn_neighbors(state, X)
    labels = np.asarray(state["y"])[neigh]
    n_classes = len(state["classes"])
    scores = np.zeros((neigh.shape[0], n_classes))
    for j in range(neigh.shape[1]):
        np.add.at(scores, (np.arange(neigh.shape[0]), labels[:, j]), 1.0)
    scores /= scores.sum(axis=1, keepdims=True)
    return scores


def knn_predict(state: dict, X) -> np.ndarray:
    return np.asarray(state["classes"])[
        np.argmax(knn_predict_proba(state, X), axis=1)]


# -- trees (rf, gbc) ------------------------------------------------------


def _tree_arrays(trees) -> dict:
    """Fitted ``tree_`` objects -> concatenated node arrays with global
    child indices (-1 at a leaf) and each tree's root offset."""
    offsets = np.zeros(len(trees) + 1, np.int64)
    left, right, feat, thr, miss, value = [], [], [], [], [], []
    for i, t in enumerate(trees):
        n = int(t.node_count)
        offsets[i + 1] = offsets[i] + n
        lc = np.asarray(t.children_left, np.int64)
        rc = np.asarray(t.children_right, np.int64)
        left.append(np.where(lc >= 0, lc + offsets[i], -1))
        right.append(np.where(rc >= 0, rc + offsets[i], -1))
        feat.append(np.asarray(t.feature, np.int32))
        thr.append(np.asarray(t.threshold, np.float64))
        miss.append(np.asarray(getattr(t, "missing_go_to_left",
                                       np.zeros(n, np.uint8)), np.uint8))
        value.append(np.asarray(t.value, np.float64).reshape(n, -1))
    return {"offsets": offsets, "left": np.concatenate(left),
            "right": np.concatenate(right), "feature": np.concatenate(feat),
            "threshold": np.concatenate(thr),
            "missing_left": np.concatenate(miss),
            "value": np.concatenate(value)}


def tree_apply(state: dict, t: int, X32: np.ndarray,
               nan_aware: bool) -> np.ndarray:
    """Leaf node (global index) of each float32 row in tree ``t``: a row
    goes left where its feature, in double, is ``<=`` the threshold;
    ``nan_aware`` sends NaN by ``missing_go_to_left`` (``Tree.apply``),
    else right (the boosting stages' fast path)."""
    left, right = state["left"], state["right"]
    feat, thr = state["feature"], state["threshold"]
    node = np.full(X32.shape[0], state["offsets"][t], np.int64)
    live = np.arange(X32.shape[0])
    while live.size:
        nd = node[live]
        inner = left[nd] >= 0
        live, nd = live[inner], nd[inner]
        if not live.size:
            break
        x = X32[live, feat[nd]].astype(np.float64)
        go_left = x <= thr[nd]
        if nan_aware:
            nan = np.isnan(x)
            go_left = np.where(nan, state["missing_left"][nd] != 0, go_left)
        node[live] = np.where(go_left, left[nd], right[nd])
    return node


def rf_predict_proba(state: dict, X) -> np.ndarray:
    X32 = _rows(X, np.float32)
    n_trees = len(state["offsets"]) - 1
    value = state["value"]
    proba = np.zeros((X32.shape[0], value.shape[1]))
    for t in range(n_trees):
        proba += value[tree_apply(state, t, X32, nan_aware=True)]
    proba /= n_trees
    return proba


def rf_predict(state: dict, X) -> np.ndarray:
    return np.asarray(state["classes"])[
        np.argmax(rf_predict_proba(state, X), axis=1)]


def gbc_raw(state: dict, X) -> np.ndarray:
    """The decision function: ``init_raw`` plus ``learning_rate`` times a
    leaf value for each stage and class, in stage order."""
    X32 = _rows(X, np.float32)
    n_class = len(state["init_raw"])
    raw = np.tile(np.asarray(state["init_raw"], np.float64),
                  (X32.shape[0], 1))
    lr = float(state["learning_rate"])
    value = state["value"][:, 0]
    for t in range(len(state["offsets"]) - 1):
        k = t % n_class
        raw[:, k] += lr * value[tree_apply(state, t, X32, nan_aware=False)]
    return raw


def softmax(raw: np.ndarray) -> np.ndarray:
    """``sklearn.utils.extmath.softmax``, op for op."""
    p = np.array(raw, copy=True)
    p -= np.max(p, axis=1).reshape(-1, 1)
    np.exp(p, out=p)
    p /= np.sum(p, axis=1).reshape(-1, 1)
    return p


def gbc_predict_proba(state: dict, X) -> np.ndarray:
    return softmax(gbc_raw(state, X))


def gbc_predict(state: dict, X) -> np.ndarray:
    return np.asarray(state["classes"])[np.argmax(gbc_raw(state, X),
                                                  axis=1)]


# -- svc ------------------------------------------------------------------


def svc_decision(state: dict, X) -> np.ndarray:
    """``(n, k(k-1)/2)`` one-vs-one decision values in libsvm's pair order
    ``(0,1), (0,2), ..., (k-2,k-1)``."""
    X = _rows(X, np.float64)
    sv = _rows(state["support_vectors"], np.float64)
    sv_norm = state.get("_sv_norm")
    if sv_norm is None:
        sv_norm = state["_sv_norm"] = _sq_norms(sv)
    d2 = -2.0 * (X @ sv.T)
    d2 += _sq_norms(X)[:, None]
    d2 += sv_norm[None, :]
    np.maximum(d2, 0.0, out=d2)
    kv = np.exp(-float(state["gamma"]) * d2)
    coef = np.asarray(state["dual_coef"], np.float64)
    rho = -np.asarray(state["intercept"], np.float64)
    n_sv = np.asarray(state["n_support"], np.int64)
    start = np.concatenate([[0], np.cumsum(n_sv)[:-1]])
    k = len(n_sv)
    dec = np.empty((X.shape[0], k * (k - 1) // 2))
    p = 0
    for i in range(k):
        for j in range(i + 1, k):
            si, sj = start[i], start[j]
            dec[:, p] = (kv[:, si:si + n_sv[i]] @ coef[j - 1, si:si + n_sv[i]]
                         + kv[:, sj:sj + n_sv[j]] @ coef[i, sj:sj + n_sv[j]]
                         - rho[p])
            p += 1
    return dec


def _sigmoid_predict(dec, a, b) -> np.ndarray:
    """libsvm's ``sigmoid_predict``, both branches as written there."""
    f = dec * a + b
    out = np.empty_like(f)
    pos = f >= 0
    e = np.exp(-f[pos])
    out[pos] = e / (1.0 + e)
    out[~pos] = 1.0 / (1 + np.exp(f[~pos]))
    return out


def multiclass_probability(r: np.ndarray) -> np.ndarray:
    """libsvm's ``multiclass_probability`` (Wu, Lin and Weng's method 2)
    for each row of ``r`` (``(n, k, k)`` pairwise probabilities), its
    sweeps and stopping rule per row, every operation in its order."""
    n, k = r.shape[0], r.shape[1]
    eps = 0.005 / k
    Q = np.zeros((n, k, k))
    for t in range(k):
        for j in range(t):
            Q[:, t, t] += r[:, j, t] * r[:, j, t]
            Q[:, t, j] = Q[:, j, t]
        for j in range(t + 1, k):
            Q[:, t, t] += r[:, j, t] * r[:, j, t]
            Q[:, t, j] = -r[:, j, t] * r[:, t, j]
    p = np.full((n, k), 1.0 / k)
    live = np.arange(n)
    for _ in range(max(_SVM_MAX_ITER, k)):
        Ql, pl = Q[live], p[live]
        Qp = np.zeros((live.size, k))
        pQp = np.zeros(live.size)
        for t in range(k):
            for j in range(k):
                Qp[:, t] += Ql[:, t, j] * pl[:, j]
            pQp += pl[:, t] * Qp[:, t]
        err = np.zeros(live.size)
        for t in range(k):
            err = np.maximum(err, np.abs(Qp[:, t] - pQp))
        going = err >= eps
        live, Ql, pl, Qp, pQp = (live[going], Ql[going], pl[going],
                                 Qp[going], pQp[going])
        if not live.size:
            break
        for t in range(k):
            diff = (-Qp[:, t] + pQp) / Ql[:, t, t]
            pl[:, t] += diff
            pQp = ((pQp + diff * (diff * Ql[:, t, t] + 2 * Qp[:, t]))
                   / (1 + diff) / (1 + diff))
            for j in range(k):
                Qp[:, j] = (Qp[:, j] + diff * Ql[:, t, j]) / (1 + diff)
                pl[:, j] /= (1 + diff)
        p[live] = pl
    return p


def svc_predict_proba(state: dict, X) -> np.ndarray:
    dec = svc_decision(state, X)
    k = len(state["n_support"])
    a = np.asarray(state["prob_a"], np.float64)
    b = np.asarray(state["prob_b"], np.float64)
    r = np.zeros((dec.shape[0], k, k))
    p = 0
    for i in range(k):
        for j in range(i + 1, k):
            r[:, i, j] = np.minimum(np.maximum(
                _sigmoid_predict(dec[:, p], a[p], b[p]), _SVM_MIN_PROB),
                1 - _SVM_MIN_PROB)
            r[:, j, i] = 1 - r[:, i, j]
            p += 1
    return multiclass_probability(r)


def svc_predict(state: dict, X) -> np.ndarray:
    """libsvm's one-vs-one vote: a positive decision value votes for the
    pair's first class; the first class of most votes wins."""
    dec = svc_decision(state, X)
    k = len(state["n_support"])
    votes = np.zeros((dec.shape[0], k), np.int64)
    p = 0
    for i in range(k):
        for j in range(i + 1, k):
            pos = dec[:, p] > 0
            votes[pos, i] += 1
            votes[~pos, j] += 1
            p += 1
    return np.asarray(state["classes"])[np.argmax(votes, axis=1)]


# -- gpc ------------------------------------------------------------------


def _gpc_binary(state: dict, b: int, X, sq_dist) -> np.ndarray:
    """Binary estimator ``b``'s positive-class probability
    (``_BinaryGaussianProcessClassifierLaplace.predict_proba[:, 1]``);
    ``sq_dist`` the ``cdist`` of the scaled training and query rows."""
    from scipy.linalg import solve_triangular
    from scipy.special import erf

    c = np.float64(state["constant"][b])
    # Product(ConstantKernel, RBF): k1(X, Y) * k2(X, Y)
    k_star = (np.full(sq_dist.shape, c) * np.exp(-0.5 * sq_dist))
    f_star = k_star.T.dot(state["y_train"][b] - state["pi"][b])
    # scikit-learn calls scipy.linalg.solve on the Cholesky factor L_,
    # which is lower triangular: the triangular solve gives its values to
    # rounding (about 1e-13 apart) at half the work of the LU
    v = solve_triangular(state["L"][b], state["w_sr"][b][:, np.newaxis]
                         * k_star, lower=True)
    var_f = (np.full(X.shape[0], c) * np.ones(X.shape[0])
             - np.einsum("ij,ij->j", v, v))
    alpha = 1 / (2 * var_f)
    gamma = _GPC_LAMBDAS * f_star
    integrals = (np.sqrt(np.pi / alpha)
                 * erf(gamma * np.sqrt(alpha / (alpha + _GPC_LAMBDAS ** 2)))
                 / (2 * np.sqrt(var_f * 2 * np.pi)))
    return (_GPC_COEFS * integrals).sum(axis=0) + 0.5 * _GPC_COEFS.sum()


def _gpc_scores(state: dict, X) -> np.ndarray:
    """``(n, n_binary)`` positive-class probabilities of every binary
    estimator.  ``validate_data(dtype="numeric")`` keeps float rows as
    they are; the RBF's distances (``scipy.spatial.distance.cdist`` of
    the rows over the length scale) are taken once per distinct length
    scale, since the binaries share their training rows."""
    from scipy.spatial.distance import cdist

    X = np.asarray(X)
    if X.dtype.kind not in "fiu":
        X = X.astype(np.float64)
    X = np.ascontiguousarray(X)
    x_train = state["x_train"]
    dists = {}
    out = []
    for b in range(len(state["constant"])):
        # a 0-d float64 array, as _check_length_scale makes it: float32
        # rows divided by it become float64 (by a Python float they
        # would stay float32)
        ls = np.squeeze(np.asarray(state["length_scale"][b])).astype(float)
        if float(ls) not in dists:
            dists[float(ls)] = cdist(x_train / ls, X / ls,
                                     metric="sqeuclidean")
        out.append(_gpc_binary(state, b, X, dists[float(ls)]))
    return np.array(out).T


def gpc_predict_proba(state: dict, X) -> np.ndarray:
    Y = _gpc_scores(state, X)
    row_sums = np.sum(Y, axis=1)[:, np.newaxis]
    np.divide(Y, row_sums, out=Y, where=row_sums != 0)
    return Y


def gpc_predict(state: dict, X) -> np.ndarray:
    return np.asarray(state["classes"])[
        np.argmax(_gpc_scores(state, X), axis=1)]


_PROBA = {"knn": knn_predict_proba, "rf": rf_predict_proba,
          "gbc": gbc_predict_proba, "svc": svc_predict_proba,
          "gpc": gpc_predict_proba}
_PREDICT = {"knn": knn_predict, "rf": rf_predict, "gbc": gbc_predict,
            "svc": svc_predict, "gpc": gpc_predict}
#: the scalars of each kind's state (the file's header holds them)
_SCALARS = {"knn": ("n_neighbors",), "rf": (),
            "gbc": ("learning_rate",), "svc": ("gamma",), "gpc": ()}


def _fit_state(kind: str, X, y, seed) -> dict:
    """The fitted state of ``kind`` on ``(X, y)``: the JAX registry's
    estimator with ``random_state=seed``, fitted the port's way."""
    if kind == "knn":
        return knn_fit(X, y)
    if kind in ("rf", "gbc"):
        from consensus_entropy_tpu_torch.models import tree_fit

        return (tree_fit.rf_fit if kind == "rf" else tree_fit.gbc_fit)(
            X, y, seed=seed)
    if kind == "svc":
        from consensus_entropy_tpu_torch.models.svm_fit import svc_fit

        return svc_fit(X, y, seed=seed)
    from consensus_entropy_tpu_torch.models.gpc_fit import gpc_fit

    return gpc_fit(X, y, seed=seed)


class GenericMember(Member):
    """One frozen scikit-learn-kind member: ``state`` holds its fitted
    arrays (see the module docstring and ``convert``).  ``fit`` fits any
    kind as the JAX registry's estimator with ``random_state=seed`` fits
    (knn draws nothing, gpc nothing without restarts); ``update`` is a
    no-op (JAX ``sklearn_members.py:121-122``)."""

    def __init__(self, name: str, kind: str, state: dict | None = None, *,
                 seed: int | None = None):
        if kind not in GENERIC_KINDS:
            raise ValueError(f"unknown generic member kind {kind!r}; "
                             f"choose from {GENERIC_KINDS}")
        super().__init__(name)
        self.kind = kind
        self.state = state
        self.seed = seed

    def fit(self, X, y):
        y = np.asarray(y)
        _require_all_classes(y)
        self.state = _fit_state(self.kind, X, y, self.seed)
        return self

    def update(self, X, y):
        pass  # frozen during AL, as the reference's dispatch leaves it

    def predict_proba(self, X):
        p = _PROBA[self.kind](self.state, X)
        classes = np.asarray(self.state["classes"], int)
        if p.shape[1] == NUM_CLASSES:
            return p
        full = np.zeros((p.shape[0], NUM_CLASSES), p.dtype)
        full[:, classes] = p
        return full

    def predict(self, X):
        return _PREDICT[self.kind](self.state, X)

    def save(self, path: str) -> None:
        meta = {"kind": self.kind, "name": self.name, "generic": True,
                **{k: self.state[k] for k in _SCALARS[self.kind]}}
        arrays = {k: np.asarray(v) for k, v in self.state.items()
                  if k not in _SCALARS[self.kind] and not k.startswith("_")}
        _write_npz(path, meta, arrays)

    @classmethod
    def load(cls, path: str) -> "GenericMember":
        meta, arrays = _read_npz(path)
        if not meta.get("generic") or meta.get("kind") not in GENERIC_KINDS:
            raise ValueError(f"{path}: not a generic member file "
                             f"(kind {meta.get('kind')!r})")
        state = dict(arrays)
        for k in _SCALARS[meta["kind"]]:
            state[k] = meta[k]
        return cls(meta["name"], meta["kind"], state)
