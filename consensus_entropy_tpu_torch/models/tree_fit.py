"""Fitting the tree ensembles without scikit-learn: the random forest
(``rf``), the gradient-boosting classifier (``gbc``) and the boosted slot's
scikit-learn member (``models/members.py::BoostedTreesMember``).

Counterparts of scikit-learn 1.9.0's ``RandomForestClassifier.fit``
(``ensemble/_forest.py``: per-tree seeds drawn as ``randint(MAX_INT)``
from ``RandomState(random_state)``, bootstrap rows from
``_generate_sample_indices`` passed as ``bincount`` sample weights, 100
trees of Gini, ``max_features="sqrt"``, unlimited depth) and
``GradientBoostingClassifier.fit`` (``ensemble/_gb.py``, multinomial loss:
the ``DummyClassifier(strategy="prior")`` init in link space, per stage
and class a squared-error regression tree on the negative gradient whose
leaves take ``_update_terminal_regions``' Newton step, ``learning_rate``
times the leaf added to the raw scores; the trees' random state threaded
from ``check_random_state(random_state)``, which a warm-start ``fit``
continues).

The trees come from ``native/ce_tree.cpp`` (``native.trees_build``);
:func:`build_trees_plain` is its plain version, the same builder in
Python, which only tests call.  The per-leaf updates run here in numpy
with scikit-learn's own operations (``np.average``), so the leaf values
are its values.

The fitted state is the one ``convert`` reads from a fitted estimator
(``models/generic_members.py``'s tree arrays): nodes concatenated in tree
order with global child ids, ``value`` per node.
"""

from __future__ import annotations

import math

import numpy as np

from consensus_entropy_tpu_torch.models.members import (
    MAX_INT,
    _check_random_state,
    _our_rand_r,
)

#: ``sklearn/utils/_random.pxd``'s ``RAND_R_MAX``
RAND_R_MAX = 2 ** 31 - 1
#: ``DecisionTree*``'s ``max_depth=None``
UNLIMITED_DEPTH = 2 ** 31 - 1
_FEATURE_THRESHOLD = np.float32(1e-7)
_EPSILON = np.finfo(np.float64).eps
_TREE_LEAF = -1
_TREE_UNDEFINED = -2
#: the member state's tree arrays
TREE_KEYS = ("offsets", "left", "right", "feature", "threshold",
             "missing_left", "value")


def float_rows(X) -> np.ndarray:
    """``validate_data(dtype=np.float32)``: C-contiguous float32 rows,
    which must be finite (the fitters do not take missing values)."""
    X = np.ascontiguousarray(X, np.float32)
    if X.ndim != 2:
        raise ValueError(f"expected 2-D feature rows, got shape {X.shape}")
    if not np.isfinite(X).all():
        raise ValueError("the tree fitters take finite rows only")
    return X


def forest_state(out: dict) -> dict:
    """``native.trees_build``'s output -> the member's tree arrays
    (``generic_members._tree_arrays``' layout: global child ids)."""
    offsets = out["offsets"]
    tree_of = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    base = offsets[:-1][tree_of]
    left, right = out["left"], out["right"]
    return {"offsets": offsets.astype(np.int64),
            "left": np.where(left >= 0, left + base, -1).astype(np.int64),
            "right": np.where(right >= 0, right + base, -1).astype(np.int64),
            "feature": out["feature"].astype(np.int32),
            "threshold": out["threshold"].astype(np.float64),
            "missing_left": out["missing_left"].astype(np.uint8),
            "value": out["value"].astype(np.float64)}


# -- the random forest ----------------------------------------------------


def rf_fit(X, y, *, seed, plain: bool = False) -> dict:
    """``RandomForestClassifier(random_state=seed, warm_start=True)
    .fit(X, y)`` on a fresh estimator (100 trees) -> the ``rf`` member's
    state."""
    n_estimators = 100
    from consensus_entropy_tpu_torch import native

    X32 = float_rows(X)
    classes, y_idx = np.unique(np.asarray(y), return_inverse=True)
    n, f = X32.shape
    rs = _check_random_state(seed)
    tree_seeds = [rs.randint(MAX_INT) for _ in range(n_estimators)]
    sw = np.empty((n_estimators, n), np.float64)
    split_seeds = np.empty(n_estimators, np.uint32)
    for t, ts in enumerate(tree_seeds):
        boot = np.random.RandomState(ts).randint(0, n, n).astype(np.int32)
        sw[t] = np.bincount(boot, minlength=n)
        # the tree's own fit: check_random_state(ts), one draw at
        # Splitter.init
        split_seeds[t] = np.random.RandomState(ts).randint(0, RAND_R_MAX)
    out = native.trees_build(
        X32, y_idx.astype(np.float64), sw, split_seeds, criterion="gini",
        n_classes=len(classes), max_features=max(1, int(np.sqrt(f))),
        max_depth=UNLIMITED_DEPTH, plain=plain)
    return {"classes": classes, **forest_state(out)}


# -- gradient boosting ----------------------------------------------------


def _prior_raw(y_idx: np.ndarray, n_classes: int) -> np.ndarray:
    """``_init_raw_predictions`` of ``DummyClassifier(strategy="prior")``
    for one row: the class frequencies clipped to ``[eps, 1 - eps]`` and
    taken to ``MultinomialLogit.link`` (log over the geometric mean)."""
    from scipy.stats import gmean

    counts = np.bincount(y_idx, minlength=n_classes)
    prior = counts / counts.sum()
    eps = np.finfo(np.float64).eps
    proba = np.clip(np.tile(prior, (1, 1)), eps, 1 - eps, dtype=np.float64)
    gm = gmean(proba, axis=1)
    return np.log(proba / gm[:, None])[0]


def _safe_divide(numerator, denominator) -> float:
    """``ensemble/_gb.py::_safe_divide``."""
    if abs(denominator) < 1e-150:
        return 0.0
    return float(numerator) / float(denominator)


class GradientBoosting:
    """``GradientBoostingClassifier(max_depth=max_depth,
    n_estimators=n_estimators, learning_rate=learning_rate,
    random_state=random_state, warm_start=True)`` for three or more
    classes.  :meth:`fit` grows the model to ``n_estimators`` stages: from
    the prior on the first call, from the stages already fitted (raw scores
    recomputed on the new rows, the random state continued) on a later
    one, as scikit-learn's warm start does."""

    def __init__(self, *, max_depth: int, n_estimators: int,
                 learning_rate: float = 0.1, random_state=None):
        self.max_depth = int(max_depth)
        self.n_estimators = int(n_estimators)
        self.learning_rate = float(learning_rate)
        self.random_state = random_state
        self.classes_ = None
        self.init_raw = None
        self.trees = None  # the member's tree arrays, stage-major
        self.rng = None

    @property
    def fitted(self) -> bool:
        return self.trees is not None

    @property
    def n_stages(self) -> int:
        if self.trees is None:
            return 0
        return (len(self.trees["offsets"]) - 1) // len(self.classes_)

    def state(self) -> dict:
        """The ``gbc`` member's state (``convert._gbc_state``'s keys)."""
        if self.trees is None:
            raise ValueError("GradientBoosting is not fitted")
        return {"classes": self.classes_, "init_raw": self.init_raw,
                "learning_rate": self.learning_rate, **self.trees}

    def raw(self, X32) -> np.ndarray:
        from consensus_entropy_tpu_torch.models.generic_members import (
            gbc_raw,
        )

        return gbc_raw(self.state(), X32)

    def fit(self, X, y, *, plain: bool = False) -> "GradientBoosting":
        X32 = float_rows(X)
        classes, y_idx = np.unique(np.asarray(y), return_inverse=True)
        if len(classes) < 3:
            raise ValueError("GradientBoosting fits the multi-class model "
                             f"(3 or more classes); got {len(classes)}")
        if self.fitted:
            if not np.array_equal(classes, self.classes_):
                raise ValueError(f"warm start with classes {classes}, "
                                 f"fitted on {self.classes_}")
            if self.n_estimators < self.n_stages:
                raise ValueError(
                    f"n_estimators={self.n_estimators} must be larger or "
                    f"equal to the {self.n_stages} stages fitted when "
                    "warm_start==True")
            raw = self.raw(X32)
        else:
            self.classes_ = classes
            self.init_raw = _prior_raw(y_idx, len(classes))
            raw = np.tile(self.init_raw, (X32.shape[0], 1))
            self.rng = _check_random_state(self.random_state)
            self.trees = None
        y_f = y_idx.astype(np.float64)
        for _ in range(self.n_stages, self.n_estimators):
            self._fit_stage(X32, y_f, raw, plain)
        return self

    def _fit_stage(self, X32, y_f, raw, plain) -> None:
        """``BaseGradientBoosting._fit_stage``: one tree a class on the
        negative gradient at the stage's start, each leaf a Newton step,
        ``raw`` updated in place."""
        from consensus_entropy_tpu_torch import native
        from consensus_entropy_tpu_torch.models.generic_members import (
            tree_apply,
        )

        n, f = X32.shape
        K = len(self.classes_)
        neg_g = native.multinomial_neg_gradient(raw, y_f, plain=plain)
        # each class's tree draws its splitter seed from the shared random
        # state, in class order, before the next tree is made
        seeds = np.array([self.rng.randint(0, RAND_R_MAX) for _ in range(K)],
                         np.uint32)
        sw = np.ones(n, np.float64)
        out = native.trees_build(
            X32, np.ascontiguousarray(neg_g.T), sw, seeds, criterion="mse",
            max_features=f, max_depth=self.max_depth,
            parallel_features=True, plain=plain)
        stage = forest_state(out)
        value = stage["value"]
        for k in range(K):
            y_k = np.array(y_f == k, dtype=np.float64)
            leaf = tree_apply(stage, k, X32, nan_aware=True)
            lo, hi = stage["offsets"][k], stage["offsets"][k + 1]
            local = leaf - lo
            for node in np.nonzero(out["left"][lo:hi] == _TREE_LEAF)[0]:
                indices = np.nonzero(local == node)[0]
                y_ = y_k.take(indices, axis=0)
                sw_ = sw[indices]
                g = neg_g[:, k].take(indices, axis=0)
                prob = y_ - g
                numerator = np.average(g, weights=sw_)
                numerator *= (K - 1) / K
                denominator = np.average(prob * (1 - prob), weights=sw_)
                value[lo + node, 0] = _safe_divide(numerator, denominator)
            raw[:, k] += self.learning_rate * value[:, 0].take(leaf, axis=0)
        self._append(stage)

    def _append(self, stage: dict) -> None:
        if self.trees is None:
            self.trees = stage
            return
        shift = len(self.trees["left"])
        t = self.trees
        self.trees = {
            "offsets": np.concatenate([t["offsets"],
                                       stage["offsets"][1:] + shift]),
            **{k: np.concatenate([t[k], np.where(stage[k] >= 0,
                                                 stage[k] + shift, -1)])
               for k in ("left", "right")},
            **{k: np.concatenate([t[k], stage[k]])
               for k in ("feature", "threshold", "missing_left", "value")}}


def gbc_fit(X, y, *, seed, plain: bool = False) -> dict:
    """``GradientBoostingClassifier(max_depth=2, random_state=seed,
    warm_start=True).fit(X, y)`` (100 stages) -> the ``gbc`` member's
    state."""
    return GradientBoosting(max_depth=2, n_estimators=100,
                            random_state=seed).fit(X, y, plain=plain).state()


# -- the plain builder ----------------------------------------------------


def _simultaneous_sort(v: list, idx: list, lo: int, n: int) -> None:
    """``utils/_sorting.pyx``'s 3-way introsort of ``v[lo:lo+n]`` (and
    ``idx`` alongside), every swap in its order."""
    if n == 0:
        return

    def swap(i, j):
        v[i], v[j] = v[j], v[i]
        idx[i], idx[j] = idx[j], idx[i]

    def insertion(lo, n):
        for i in range(lo + 1, lo + n):
            tv, ti, j = v[i], idx[i], i
            while j > lo and v[j - 1] > tv:
                v[j], idx[j] = v[j - 1], idx[j - 1]
                j -= 1
            v[j], idx[j] = tv, ti

    def sift(lo, start, end):
        root = start
        while True:
            child = root * 2 + 1
            m = root
            if child < end and v[lo + m] < v[lo + child]:
                m = child
            if child + 1 < end and v[lo + m] < v[lo + child + 1]:
                m = child + 1
            if m == root:
                return
            swap(lo + root, lo + m)
            root = m

    def heapsort(lo, n):
        start = (n - 2) // 2 if n >= 2 else 0
        while True:
            sift(lo, start, n)
            if start == 0:
                break
            start -= 1
        end = n - 1
        while end > 0:
            swap(lo, lo + end)
            sift(lo, 0, end)
            end -= 1

    def median3(lo, n):
        a, b, c = v[lo], v[lo + n // 2], v[lo + n - 1]
        if a < b:
            return b if b < c else (c if a < c else a)
        if b < c:
            return a if a < c else c
        return b

    def intro(lo, n, maxd):
        while n > 15:
            if maxd <= 0:
                heapsort(lo, n)
                return
            maxd -= 1
            pivot = median3(lo, n)
            i = left = 0
            r = n
            while i < r:
                if v[lo + i] < pivot:
                    swap(lo + i, lo + left)
                    i += 1
                    left += 1
                elif v[lo + i] > pivot:
                    r -= 1
                    swap(lo + i, lo + r)
                else:
                    i += 1
            intro(lo, left, maxd)
            lo += r
            n -= r
        insertion(lo, n)

    intro(lo, n, 2 * int(math.log2(n)))


def _plain_tree(X32, y, sw, seed, gini, n_classes, max_features,
                max_depth) -> dict:
    """``DepthFirstTreeBuilder.build`` with the best splitter, in Python
    (``native/ce_tree.cpp``'s ``build_tree`` line for line), splits of at
    least 2 rows into leaves of at least 1."""
    n, F = X32.shape
    rand = [int(seed) & 0xFFFFFFFF]

    def rand_int(low, high):
        rand[0], r = _our_rand_r(rand[0])
        return low + r % (high - low)

    samples = [i for i in range(n) if sw[i] != 0.0]
    wn_samples = 0.0
    for i in range(n):
        wn_samples += float(sw[i])
    features = list(range(F))
    constant = [0] * F
    vs = n_classes if gini else 1
    y = [float(v) for v in y]
    w_of = [float(v) for v in sw]
    X = X32  # float32 values, compared in float32 as the core does
    nodes = {k: [] for k in ("left", "right", "feature", "threshold",
                             "missing_left", "value")}

    def sums(lo, hi):
        tot = [0.0] * vs
        sq = 0.0
        wn = 0.0
        for p in range(lo, hi):
            i = samples[p]
            w = w_of[i]
            if gini:
                tot[int(y[i])] += w
            else:
                wy = w * y[i]
                tot[0] += wy
                sq += wy * y[i]
            wn += w
        return tot, sq, wn

    def impurity_of(tot, sq, wn):
        if gini:
            s = 0.0
            for c in tot:
                s += c * c
            return 1.0 - s / (wn * wn)
        return sq / wn - (tot[0] / wn) ** 2.0

    def children(lo, pos, left, right, wl, wr, sq_total):
        if gini:
            sl = sr = 0.0
            for c in range(vs):
                sl += left[c] * left[c]
                sr += right[c] * right[c]
            return 1.0 - sl / (wl * wl), 1.0 - sr / (wr * wr)
        sq_left = 0.0
        for p in range(lo, pos):
            i = samples[p]
            sq_left += w_of[i] * y[i] * y[i]
        il = sq_left / wl - (left[0] / wl) ** 2.0
        ir = (sq_total - sq_left) / wr - (right[0] / wr) ** 2.0
        return il, ir

    stack = [(0, len(samples), 0, _TREE_UNDEFINED, False, math.inf, 0)]
    first = True
    while stack:
        start, end, depth, parent, is_left, imp, n_const = stack.pop()
        tot, sq_total, wn = sums(start, end)
        nn = end - start
        is_leaf = depth >= max_depth or nn < 2 or wn < 0.0
        if first:
            imp = impurity_of(tot, sq_total, wn)
            first = False
        is_leaf = is_leaf or imp <= _EPSILON
        best = None
        if not is_leaf:
            best_proxy = -math.inf
            f_i, n_visited, n_found, n_drawn = F, 0, 0, 0
            n_known = n_total = n_const
            while f_i > n_total and (n_visited < max_features
                                     or n_visited <= n_found + n_drawn):
                n_visited += 1
                f_j = rand_int(n_drawn, f_i - n_found)
                if f_j < n_known:
                    features[n_drawn], features[f_j] = (features[f_j],
                                                        features[n_drawn])
                    n_drawn += 1
                    continue
                f_j += n_found
                feat = features[f_j]
                fv = [None] * n
                for p in range(start, end):
                    fv[p] = X[samples[p], feat]
                _simultaneous_sort(fv, samples, start, end - start)
                if fv[end - 1] <= fv[start] + _FEATURE_THRESHOLD:
                    features[f_j], features[n_total] = (features[n_total],
                                                        features[f_j])
                    n_found += 1
                    n_total += 1
                    continue
                f_i -= 1
                features[f_i], features[f_j] = features[f_j], features[f_i]
                left = [0.0] * vs
                wl, pos, p = 0.0, start, start
                while p < end:
                    p += 1
                    while p < end and fv[p] <= fv[p - 1] + _FEATURE_THRESHOLD:
                        p += 1
                    p_prev = p - 1
                    if p == end:
                        continue
                    n_left, n_right = p - start, end - p
                    if n_left < 1 or n_right < 1:
                        continue
                    # Criterion.update(p)
                    if (p - pos) <= (end - p):
                        for q in range(pos, p):
                            i = samples[q]
                            if gini:
                                left[int(y[i])] += w_of[i]
                            else:
                                left[0] += w_of[i] * y[i]
                            wl += w_of[i]
                    else:
                        left = list(tot)
                        wl = wn
                        for q in range(end - 1, p - 1, -1):
                            i = samples[q]
                            if gini:
                                left[int(y[i])] -= w_of[i]
                            else:
                                left[0] -= w_of[i] * y[i]
                            wl -= w_of[i]
                    pos = p
                    wr = wn - wl
                    right = [tot[c] - left[c] for c in range(vs)]
                    if wl < 0.0 or wr < 0.0:
                        continue
                    if gini:
                        il, ir = children(start, p, left, right, wl, wr,
                                          sq_total)
                        proxy = -wr * ir - wl * il
                    else:
                        proxy = (left[0] * left[0] / wl
                                 + right[0] * right[0] / wr)
                    if proxy > best_proxy:
                        best_proxy = proxy
                        thr = (float(fv[p_prev]) / 2.0
                               + float(fv[p]) / 2.0)
                        best = [feat, p, thr, n_left > n_right]
            if best is not None:
                feat, bpos, thr = best[0], best[1], best[2]
                ps, pe = start, end
                while ps < pe:
                    if float(X[samples[ps], feat]) <= thr:
                        ps += 1
                    else:
                        pe -= 1
                        samples[ps], samples[pe] = samples[pe], samples[ps]
                left, wl = [0.0] * vs, 0.0
                if (bpos - start) <= (end - bpos):
                    for q in range(start, bpos):
                        i = samples[q]
                        if gini:
                            left[int(y[i])] += w_of[i]
                        else:
                            left[0] += w_of[i] * y[i]
                        wl += w_of[i]
                else:
                    left, wl = list(tot), wn
                    for q in range(end - 1, bpos - 1, -1):
                        i = samples[q]
                        if gini:
                            left[int(y[i])] -= w_of[i]
                        else:
                            left[0] -= w_of[i] * y[i]
                        wl -= w_of[i]
                wr = wn - wl
                right = [tot[c] - left[c] for c in range(vs)]
                il, ir = children(start, bpos, left, right, wl, wr, sq_total)
                improvement = ((wn / wn_samples)
                               * (imp - (wr / wn * ir) - (wl / wn * il)))
                best += [il, ir, improvement]
            features[:n_known] = constant[:n_known]
            constant[n_known:n_known + n_found] = \
                features[n_known:n_known + n_found]
            n_const = n_total
            is_leaf = (best is None or best[1] >= end
                       or best[6] + _EPSILON < 0.0)
        node_id = len(nodes["left"])
        if parent != _TREE_UNDEFINED:
            nodes["left" if is_left else "right"][parent] = node_id
        nodes["left"].append(_TREE_LEAF)
        nodes["right"].append(_TREE_LEAF)
        nodes["feature"].append(_TREE_UNDEFINED if is_leaf else best[0])
        nodes["threshold"].append(float(_TREE_UNDEFINED) if is_leaf
                                  else best[2])
        nodes["missing_left"].append(0 if is_leaf else int(best[3]))
        nodes["value"].append([c / wn for c in tot])
        if not is_leaf:
            stack.append((best[1], end, depth + 1, node_id, False, best[5],
                          n_const))
            stack.append((start, best[1], depth + 1, node_id, True, best[4],
                          n_const))
    return nodes


def build_trees_plain(X32, y, sw, seeds, *, criterion: str, n_classes: int,
                      max_features: int, max_depth: int) -> dict:
    """``native.trees_build(..., plain=True)``: each tree by
    :func:`_plain_tree`, the output in the core's layout."""
    trees = [_plain_tree(X32, y[t], sw[t], int(seeds[t]),
                         criterion == "gini", n_classes, max_features,
                         max_depth)
             for t in range(len(seeds))]
    counts = [len(t["left"]) for t in trees]
    vs = n_classes if criterion == "gini" else 1
    cat = {k: np.concatenate([np.asarray(t[k], dt) for t in trees])
           for k, dt in (("left", np.int64), ("right", np.int64),
                         ("feature", np.int64), ("threshold", np.float64),
                         ("missing_left", np.uint8))}
    cat["value"] = np.concatenate(
        [np.asarray(t["value"], np.float64).reshape(-1, vs) for t in trees])
    cat["offsets"] = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return cat
