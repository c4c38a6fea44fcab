"""The host members' predictions, fits and updates, in numpy.

Frozen copies of scikit-learn's arithmetic as the committee's host
members use it (``GaussianNB``, ``SGDClassifier(loss="log_loss")`` one
against the rest, and the xgb slot's softmax boosting over quantile bins),
taking each member's fitted arrays as plain numpy: the predictions, the
GaussianNB and SGD fits and updates, the boosted trees' bin edges, and a
check of each boosted tree against the rows it was grown from.
Departures: none in the arithmetic; sums are numpy's pairwise sums, so a
value may differ from a compiled core's in the last bits.
"""

from __future__ import annotations

import math

import numpy as np


def _full(p: np.ndarray, classes, n_class: int) -> np.ndarray:
    if p.shape[1] == n_class:
        return p
    out = np.zeros((p.shape[0], n_class), p.dtype)
    out[:, np.asarray(classes, int)] = p
    return out


def gnb_proba(X, theta, var, prior) -> np.ndarray:
    """GaussianNB posteriors: the joint log-likelihood in float64."""
    X = np.asarray(X, np.float64)
    theta, var = np.asarray(theta, np.float64), np.asarray(var, np.float64)
    jll = np.empty((X.shape[0], theta.shape[0]))
    for k in range(theta.shape[0]):
        norm = np.log(prior[k]) - 0.5 * np.sum(np.log(2.0 * np.pi * var[k]))
        jll[:, k] = norm - 0.5 * np.sum((X - theta[k]) ** 2 / var[k], axis=1)
    jll -= jll.max(axis=1, keepdims=True)
    p = np.exp(jll)
    return (p / p.sum(axis=1, keepdims=True)).astype(np.float32)


def sgd_proba(X, coef, intercept) -> np.ndarray:
    """One-against-the-rest logistic probabilities, L1-normalised."""
    z = (np.asarray(X, np.float32) @ np.asarray(coef, np.float32).T
         + np.asarray(intercept, np.float32))
    e = np.exp(-np.abs(z))
    p = np.where(z >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
    s = p.sum(axis=1, keepdims=True)
    zero = s[:, 0] == 0
    s[zero] = 1.0
    p = p / s
    p[zero] = 1.0 / p.shape[1]
    return p.astype(np.float32)


def gbdt_proba(X, edges, feature, threshold, value, tree_class, n_class,
               lr, device="cpu") -> np.ndarray:
    """Softmax over the forest's margins: features binned by
    ``searchsorted(edges, x, 'left')``, heap-ordered trees (children of
    node ``i`` at ``2i + 1`` and ``2i + 2``, right when the bin is above
    the threshold; a negative feature marks a leaf).  The traversal runs
    on ``device`` in torch, the margins in float64."""
    import torch

    X = np.asarray(X, np.float64)
    xb = np.empty(X.shape, np.int64)
    for j, e in enumerate(edges):
        xb[:, j] = np.searchsorted(e, X[:, j], side="left")
    feature = torch.as_tensor(np.asarray(feature, np.int64), device=device)
    n_trees, n_nodes = feature.shape
    depth = int(np.log2(n_nodes + 1)) - 1
    margins = torch.zeros((X.shape[0], n_class), dtype=torch.float64,
                          device=device)
    if n_trees:
        thr = torch.as_tensor(np.asarray(threshold, np.int64), device=device)
        val = torch.as_tensor(np.asarray(value, np.float64), device=device)
        xb_t = torch.as_tensor(xb, device=device)
        t = torch.arange(n_trees, device=device)[:, None]
        rows = torch.arange(X.shape[0], device=device)[None, :]
        node = torch.zeros((n_trees, X.shape[0]), dtype=torch.int64,
                           device=device)
        for _ in range(depth):
            f = feature[t, node]
            internal = f >= 0
            b = xb_t[rows, torch.where(internal, f, 0)]
            child = 2 * node + 1 + (b > thr[t, node]).long()
            node = torch.where(internal, child, node)
        leaf = lr * val[t, node]
        cls = torch.as_tensor(np.asarray(tree_class, np.int64),
                              device=device)
        margins.index_add_(1, cls, leaf.T)
    margins -= margins.max(dim=1, keepdim=True).values
    p = torch.exp(margins)
    return (p / p.sum(dim=1, keepdim=True)).float().cpu().numpy()


def member_proba(state: dict, X, n_class: int,
                 device="cpu") -> np.ndarray:
    """``(n, n_class)`` probabilities of one host member's state (see
    ``benchmark.check.host_state``); the boosted trees traverse on
    ``device``."""
    kind = state["kind"]
    if kind == "gnb":
        p = gnb_proba(X, state["theta"], state["var"], state["prior"])
    elif kind == "sgd":
        p = sgd_proba(X, state["coef"], state["intercept"])
    elif kind == "xgb":
        return gbdt_proba(X, state["edges"], state["feature"],
                          state["threshold"], state["value"],
                          state["tree_class"], n_class, state["lr"],
                          device)
    else:
        raise ValueError(f"no reference predict for member kind {kind!r}")
    return _full(p, state["classes"], n_class)


def member_predict(state: dict, X, n_class: int,
                   device="cpu") -> np.ndarray:
    """Class labels: the most probable class (SGD: the largest logit,
    the same class)."""
    if state["kind"] == "sgd":
        z = (np.asarray(X, np.float32) @ np.asarray(state["coef"],
                                                    np.float32).T
             + np.asarray(state["intercept"], np.float32))
        return np.asarray(state["classes"])[z.argmax(axis=1)]
    p = member_proba(state, X, n_class, device)
    return p.argmax(axis=1)


def segment_mean(P: np.ndarray, counts) -> np.ndarray:
    """The mean of consecutive runs of ``counts`` rows, in float64."""
    starts = np.r_[0, np.cumsum(counts)]
    return np.stack([P[a:b].mean(axis=0, dtype=np.float64)
                     for a, b in zip(starts[:-1], starts[1:])]).astype(
                         np.float32)


def gnb_update(state: dict, X, y, var_smoothing: float = 1e-9) -> dict:
    """GaussianNB's ``partial_fit`` of one batch (Chan, Golub and
    LeVeque's running mean and variance, the smoothing taken off and put
    back with this batch's), on a copy of the state."""
    X = np.asarray(X)
    y = np.asarray(y)
    theta, var = state["theta"].copy(), state["var"].copy()
    count = state["count"].copy()
    eps = var_smoothing * np.max(np.var(X, axis=0))
    var -= eps
    classes = np.asarray(state["classes"])
    for c in np.unique(y):
        i = int(np.searchsorted(classes, c))
        Xi = X[y == c]
        n_past, n_new = count[i], Xi.shape[0]
        new_var, new_mu = np.var(Xi, axis=0), np.mean(Xi, axis=0)
        if n_past == 0:
            theta[i], var[i] = new_mu, new_var
        else:
            n_total = float(n_past + n_new)
            mu = (n_new * new_mu + n_past * theta[i]) / n_total
            ssd = (n_past * var[i] + n_new * new_var
                   + (n_new * n_past / n_total) * (theta[i] - new_mu) ** 2)
            theta[i], var[i] = mu, ssd / n_total
        count[i] += n_new
    var += eps
    return {**state, "theta": theta, "var": var, "count": count,
            "prior": count / np.sum(count)}


def gnb_fit(X, y, var_smoothing: float = 1e-9) -> dict:
    """GaussianNB's ``fit``: the update of an empty state over the
    classes ``y`` holds, in ``X``'s float dtype."""
    X = np.asarray(X)
    classes = np.unique(np.asarray(y))
    empty = {"kind": "gnb", "classes": classes,
             "theta": np.zeros((len(classes), X.shape[1]), X.dtype),
             "var": np.zeros((len(classes), X.shape[1]), X.dtype),
             "count": np.zeros(len(classes), X.dtype)}
    # the update takes the smoothing off before it adds it back
    eps = var_smoothing * np.max(np.var(X, axis=0))
    return gnb_update({**empty, "var": empty["var"] + eps}, X, y,
                      var_smoothing)


# -- SGDClassifier(loss="log_loss"), one against the rest -------------------
#
# A frozen copy of scikit-learn 1.9's ``_plain_sgd`` (``_sgd_fast.pyx.tp``)
# for the log loss, the L2 penalty and the ``optimal`` schedule, in the
# weights' float dtype: each weight-feature product rounded to the dtype and
# summed in double, ``wscale`` kept in double, the samples shuffled each
# epoch by the dataset's xorshift Fisher-Yates; and of ``BaseSGDClassifier``'s
# ``fit`` (``max_iter`` epochs, stopping on the training objective) and
# ``partial_fit`` (one epoch), with the seeds each call draws afresh from
# ``RandomState(random_state)`` and ``t_`` carried between calls.  The
# defaults are scikit-learn's.

SGD_ALPHA, SGD_MAX_ITER, SGD_TOL, SGD_NO_CHANGE = 1e-4, 1000, 1e-3, 5
_MAX_INT = 2 ** 31 - 1


def _xorshift(state: int) -> tuple:
    if state == 0:
        state = 1
    state ^= (state << 13) & 0xFFFFFFFF
    state ^= state >> 17
    state ^= (state << 5) & 0xFFFFFFFF
    return state, state % (1 << 31)


def _shuffle(index: np.ndarray, seed: int) -> None:
    state = int(seed) & 0xFFFFFFFF
    n = len(index)
    for i in range(n - 1):
        state, r = _xorshift(state)
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
    if p > -37:
        e = math.exp(-p)
        return ((1 - y) - y * e) / (1 + e)
    return math.exp(p) - y


def _plain_sgd(w, intercept, X, y, seed, max_iter, t, alpha, tol,
               n_iter_no_change) -> tuple:
    """``w`` updated in place; returns ``(intercept, epochs run)``."""
    dt = w.dtype.type
    n = X.shape[0]
    x64 = X.astype(np.float64)
    threshold = 1e-6 if w.dtype == np.float32 else 1e-9
    index = np.arange(n, dtype=np.intc)
    wscale = 1.0
    track = max_iter > 1
    sq_norm = float(np.dot(w, w))
    typw = math.sqrt(1.0 / math.sqrt(alpha))
    optimal_init = 1.0 / (typw / max(1.0, _dloss(1.0, -typw)) * alpha)
    best, no_improvement = math.inf, 0
    prod = np.empty_like(w)
    epoch = 0
    for epoch in range(max_iter):
        objective_sum = 0.0
        _shuffle(index, seed)
        for i in range(n):
            k = index[i]
            yk = float(y[k])
            np.multiply(w, X[k], out=prod)
            p = float(dt(prod.cumsum(dtype=np.float64)[-1] * wscale)) \
                + intercept
            eta = 1.0 / (alpha * (optimal_init + t - 1))
            if track:
                norm = float(dt(math.sqrt(sq_norm)))
                objective_sum += _log1pexp(p) - yk * p
                objective_sum += alpha * (0.5 * norm ** 2)
            update = -eta * min(max(_dloss(yk, p), -1e12), 1e12)
            c = dt(max(0.0, 1.0 - eta * alpha))
            wscale *= float(c)
            sq_norm *= float(c * c)
            if wscale < threshold:
                w *= dt(wscale)
                wscale = 1.0
            if update != 0.0:
                ws = dt(wscale)
                w[:] = (w.astype(np.float64)
                        + x64[k] * float(dt(update) / ws)).astype(w.dtype)
                if track:
                    np.multiply(w, w, out=prod)
                    sq_norm = (prod.cumsum(dtype=np.float64)[-1]
                               * float(ws * ws))
                intercept += update
            t += 1
        if track:
            objective = objective_sum / n
            no_improvement = (no_improvement + 1
                              if objective > best - tol else 0)
            best = min(best, objective)
            if no_improvement >= n_iter_no_change:
                break
    w *= dt(wscale)
    return intercept, epoch + 1


def _sgd_epochs(state: dict, X, y, max_iter: int, fault: bool = False
                ) -> dict:
    X = np.ascontiguousarray(X)
    y = np.asarray(y)
    coef = state["coef"].copy()
    intercept = np.asarray(state["intercept"]).copy()
    classes = np.asarray(state["classes"])
    t = 1.0 if fault else state["t"]
    seeds = np.random.RandomState(state["random_state"]).randint(
        _MAX_INT, size=len(classes))
    n_iter = 0
    for i, seed_i in enumerate(seeds):
        y_i = np.ones(y.shape, X.dtype)
        y_i[y != classes[i]] = 0.0
        rs = np.random.RandomState(seed_i)
        rs.randint(1, np.iinfo(np.int32).max)
        icpt, n_i = _plain_sgd(coef[i], float(intercept[i]), X, y_i,
                               rs.randint(_MAX_INT), max_iter, t,
                               SGD_ALPHA, SGD_TOL, SGD_NO_CHANGE)
        intercept[i] = icpt
        n_iter = max(n_iter, n_i)
    return {**state, "coef": coef, "intercept": intercept,
            "t": t + n_iter * X.shape[0]}


def sgd_fit(X, y, random_state: int) -> dict:
    """``SGDClassifier(random_state=...).fit(X, y)``."""
    X = np.ascontiguousarray(X)
    classes = np.unique(np.asarray(y))
    empty = {"kind": "sgd", "classes": classes, "t": 1.0,
             "random_state": random_state,
             "coef": np.zeros((len(classes), X.shape[1]), X.dtype),
             "intercept": np.zeros(len(classes), X.dtype)}
    return _sgd_epochs(empty, X, y, SGD_MAX_ITER)


def sgd_update(state: dict, X, y, *, fault: bool = False) -> dict:
    """``partial_fit(X, y)``: one epoch.  ``fault``: the schedule
    restarted (``t`` not carried), a planted fault."""
    return _sgd_epochs(state, X, y, 1, fault)


# -- the xgb slot: softmax boosting over quantile bins -----------------------
#
# Not a copy of a builder: the reference holds each tree the system under
# test grows to what a depth-limited second-order tree must be on the rows
# it was grown from.  It works out the gradient statistics itself (the
# softmax of the forest's margins, ``g = p - onehot`` and ``h = max(p (1 -
# p), 1e-16)`` in float32), routes the rows through the tree, and asks that
# every leaf hold ``-G / (H + lambda)`` of its rows, that every split reach
# the best gain ``GL^2/(HL+lambda) + GR^2/(HR+lambda) - G^2/(H+lambda)``
# over every feature and threshold with both sides' hessians at least
# ``min_child_weight``, and that no leaf above the depth limit leave a split
# of positive gain.  The margins then go on with the tree's own leaves, as
# the boosting does.  XGBoost's defaults, as the member states them:

GBDT = {"lam": 1.0, "min_child_weight": 1.0, "min_gain": 0.0,
        "max_depth": 5, "n_bins": 256, "lr": 0.3, "rounds": 100}


def quantile_edges(X, n_bins: int = 256) -> list:
    """Each feature's interior quantile edges (at most ``n_bins - 1``)."""
    X = np.asarray(X, np.float64)
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    return [np.unique(np.quantile(X[:, j], qs)).astype(np.float64)
            for j in range(X.shape[1])]


def binned(X, edges) -> np.ndarray:
    X = np.asarray(X, np.float64)
    out = np.empty(X.shape, np.uint8)
    for j, e in enumerate(edges):
        out[:, j] = np.searchsorted(e, X[:, j], side="left")
    return out


def _leaves(xb, feature, threshold) -> np.ndarray:
    """Each row's leaf in one heap-ordered tree."""
    node = np.zeros(xb.shape[0], np.int64)
    rows = np.arange(xb.shape[0])
    for _ in range(int(np.log2(len(feature) + 1)) - 1):
        f = feature[node]
        inner = f >= 0
        go = xb[rows, np.where(inner, f, 0)] > threshold[node]
        node = np.where(inner, 2 * node + 1 + go, node)
    return node


def forest_margins(xb, forest: dict, n_class: int, lr: float,
                   upto: int | None = None) -> np.ndarray:
    """``(n, n_class)`` float64 margins of the first ``upto`` trees, each
    class's trees summed in forest order."""
    n = forest["feature"].shape[0] if upto is None else upto
    m = np.zeros((xb.shape[0], n_class))
    for t in range(n):
        leaf = _leaves(xb, forest["feature"][t], forest["threshold"][t])
        m[:, forest["tree_class"][t]] += lr * forest["value"][t][leaf]
    return m


def _best_gain(xb, g, h, lam, mcw) -> float:
    """The best valid split gain of one node's rows, over every feature
    and threshold (a threshold between two distinct bins)."""
    order = np.argsort(xb, axis=0, kind="stable")
    xs = np.take_along_axis(xb, order, axis=0)
    gl = np.cumsum(g[order], axis=0)[:-1]
    hl = np.cumsum(h[order], axis=0)[:-1]
    G, H = g.sum(), h.sum()
    gr, hr = G - gl, H - hl
    ok = (xs[:-1] != xs[1:]) & (hl >= mcw) & (hr >= mcw)
    if not ok.any():
        return -np.inf
    gain = gl ** 2 / (hl + lam) + gr ** 2 / (hr + lam) - G ** 2 / (H + lam)
    return float(gain[ok].max())


def tree_gap(xb, g, h, feature, threshold, value, *, lam, min_child_weight,
             min_gain, splits: bool) -> float:
    """How far one tree lies from what its rows make it: the worst leaf's
    gap to ``-G/(H+lambda)`` over the tree's largest leaf value, and with
    ``splits`` the worst shortfall of a split's gain below the best (or a
    skipped split's gain above ``min_gain``) over the node's
    ``G^2/(H+lambda)``."""
    g64, h64 = g.astype(np.float64), h.astype(np.float64)
    leaf = _leaves(xb, feature, threshold)
    used = np.unique(leaf)
    G = np.bincount(leaf, g64, len(feature))[used]
    H = np.bincount(leaf, h64, len(feature))[used]
    want = -G / (H + lam)
    scale = max(float(np.max(np.abs(want))), 1e-12)
    worst = float(np.max(np.abs(value[used] - want))) / scale
    if (feature[used] >= 0).any():
        return 1.0
    if not splits:
        return worst
    depth = int(np.log2(len(feature) + 1)) - 1
    node = np.zeros(xb.shape[0], np.int64)
    for d in range(depth + 1):
        level = np.unique(node)
        for nd in level[level >= 2 ** d - 1]:
            r = node == nd
            gs, hs = g64[r], h64[r]
            Gn, Hn = gs.sum(), hs.sum()
            norm = max(Gn ** 2 / (Hn + lam), 1e-12)
            f = feature[nd]
            if f < 0:
                if d < depth:
                    best = _best_gain(xb[r], gs, hs, lam, min_child_weight)
                    worst = max(worst, (best - min_gain) / norm)
                continue
            left = xb[r, f] <= threshold[nd]
            gl, hl = gs[left].sum(), hs[left].sum()
            gr, hr = Gn - gl, Hn - hl
            if min(hl, hr) < min_child_weight:
                return 1.0
            chosen = (gl ** 2 / (hl + lam) + gr ** 2 / (hr + lam)
                      - Gn ** 2 / (Hn + lam))
            if chosen <= min_gain:
                return 1.0
            best = _best_gain(xb[r], gs, hs, lam, min_child_weight)
            worst = max(worst, (best - chosen) / norm)
        if d < depth:
            f = feature[node]
            inner = f >= 0
            go = xb[np.arange(len(node)), np.where(inner, f, 0)] \
                > threshold[node]
            node = np.where(inner, 2 * node + 1 + go, node)
    return worst


def boost_gap(xb, y, forest: dict, first: int, n_class: int, lr: float,
              split_trees=(), lam_fault: bool = False) -> float:
    """The worst :func:`tree_gap` of trees ``first:`` of ``forest``, grown
    round by round (one tree a class) on ``(xb, y)`` from the margins of
    trees ``:first``; splits checked for the trees in ``split_trees``.
    ``lam_fault``: the leaves worked out without ``lambda`` put in the
    system's place, a planted fault's reading."""
    y = np.asarray(y, np.int64)
    onehot = np.zeros((len(y), n_class))
    onehot[np.arange(len(y)), y] = 1.0
    m = forest_margins(xb, forest, n_class, lr, first)
    n = forest["feature"].shape[0]
    if (n - first) % n_class:
        return 1.0
    worst = 0.0
    for t0 in range(first, n, n_class):
        z = m - m.max(axis=1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=1, keepdims=True)
        for k in range(n_class):
            t = t0 + k
            if forest["tree_class"][t] != k:
                return 1.0
            g = (p[:, k] - onehot[:, k]).astype(np.float32)
            h = np.maximum(p[:, k] * (1.0 - p[:, k]), 1e-16).astype(
                np.float32)
            f, thr = forest["feature"][t], forest["threshold"][t]
            value = forest["value"][t]
            if lam_fault:
                leaf = _leaves(xb, f, thr)
                G = np.bincount(leaf, g.astype(np.float64), len(f))
                H = np.bincount(leaf, h.astype(np.float64), len(f))
                value = np.where(H > 0, -G / np.maximum(H, 1e-300), 0.0)
            worst = max(worst, tree_gap(
                xb, g, h, f, thr, value, lam=GBDT["lam"],
                min_child_weight=GBDT["min_child_weight"],
                min_gain=GBDT["min_gain"], splits=t in split_trees))
            leaf = _leaves(xb, f, thr)
            m[:, k] += lr * value[leaf]
    return worst
