"""Fitting the RBF SVC member without scikit-learn.

Counterpart of scikit-learn 1.9.0's ``SVC(probability=True,
random_state=seed).fit`` (``svm/_base.py``): rows in float64, classes
sorted, ``gamma="scale"`` = ``1 / (n_features * X.var())``, C = 1, tol
1e-3, shrinking, a 200 MB kernel cache, unit sample weights, and libsvm's
``svm_train`` seeded with ``check_random_state(seed).randint(2**31 - 1)``
(``native/ce_svm.cpp``).  The fitted state is the one ``convert`` reads
from a fitted estimator (``models/generic_members.py``): support vectors
grouped by class, ``dual_coef``, ``intercept``, ``n_support``,
``prob_a``/``prob_b`` and ``gamma``.

:func:`svc_train_plain` is the core's plain version: the same solver
(working-set selection, shrinking, ``rho``, Platt scaling over the same
5-fold shuffles) in numpy, for tests at a few hundred rows.
"""

from __future__ import annotations

import math

import numpy as np

from consensus_entropy_tpu_torch.models.members import (
    MAX_INT,
    _check_random_state,
)

_TAU = 1e-12
#: ``SVC()``'s C and tol (libsvm's eps)
_C, _TOL = 1.0, 1e-3


def svc_gamma(X: np.ndarray) -> float:
    """``gamma="scale"``: ``1 / (n_features * X.var())``, 1 when the rows
    have no variance."""
    X_var = X.var()
    return 1.0 / (X.shape[1] * X_var) if X_var != 0 else 1.0


def svc_fit(X, y, *, seed, plain: bool = False) -> dict:
    """``SVC(probability=True, random_state=seed).fit(X, y)`` -> the
    ``svc`` member's state.  ``plain=True`` trains with
    :func:`svc_train_plain`."""
    from consensus_entropy_tpu_torch import native

    X = np.ascontiguousarray(X, np.float64)
    if X.ndim != 2 or not np.isfinite(X).all():
        raise ValueError("svc_fit takes finite 2-D rows")
    classes, y_idx = np.unique(np.asarray(y), return_inverse=True)
    if len(classes) < 3:
        raise ValueError("svc_fit fits the multi-class model (3 or more "
                         f"classes); got {len(classes)}")
    rnd = _check_random_state(seed)
    gamma = svc_gamma(X)
    random_seed = rnd.randint(MAX_INT)
    train = svc_train_plain if plain else native.svc_train
    out = train(X, y_idx.astype(np.float64), gamma=gamma,
                random_seed=random_seed)
    return {"classes": classes,
            "support_vectors": X[out["support"]],
            "dual_coef": out["dual_coef"], "intercept": out["intercept"],
            "n_support": out["n_support"], "prob_a": out["prob_a"],
            "prob_b": out["prob_b"], "gamma": float(gamma)}


# -- the plain version ----------------------------------------------------


def _seq_sum(a: np.ndarray, axis: int = -1) -> np.ndarray:
    """Sums accumulated left to right, as a C loop adds (``np.sum`` adds
    pairwise)."""
    return np.take(np.cumsum(a, axis=axis), -1, axis=axis)


class _MT19937:
    """``std::mt19937`` seeded with an integer, and newrand.h's
    ``bounded_rand_int``."""

    def __init__(self, seed: int = 5489):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self.bg = np.random.MT19937(0)
        self.bg._legacy_seeding(int(seed) & 0xFFFFFFFF)

    def bounded_rand_int(self, rng: int) -> int:
        x = int(self.bg.random_raw())
        m = x * rng
        low = m & 0xFFFFFFFF
        if low < rng:
            t = (-rng) & 0xFFFFFFFF
            if t >= rng:
                t -= rng
                if t >= rng:
                    t %= rng
            while low < t:
                x = int(self.bg.random_raw())
                m = x * rng
                low = m & 0xFFFFFFFF
        return m >> 32


#: libm's ``exp``, which the core calls (numpy's own may round the last
#: bit otherwise)
_exp = np.vectorize(math.exp, otypes=[np.float64])


def _rbf_q(X: np.ndarray, y: np.ndarray, gamma: float):
    """The full ``SVC_Q`` matrix (float32, as libsvm caches it) and its
    float64 diagonal, dot products summed left to right."""
    x_sq = _seq_sum(X * X)
    d = _seq_sum(X[:, None, :] * X[None, :, :])
    k = _exp(-gamma * (x_sq[:, None] + x_sq[None, :] - 2 * d))
    ys = y.astype(np.float64)
    return ((ys[:, None] * ys[None, :]) * k).astype(np.float32), np.diag(k)


def _solve(Q, QD, y, C, eps, shrinking=True):
    """libsvm's ``Solver::Solve`` for ``p = -1``, ``alpha = 0`` on a full
    ``Q``: returns ``(alpha, rho, iterations)``, ``alpha`` in the caller's
    order."""
    l = len(y)
    Q, QD, y, C = Q.copy(), QD.copy(), y.copy(), C.astype(np.float64)
    p = np.full(l, -1.0)
    alpha = np.zeros(l)
    LOWER, UPPER, FREE = 0, 1, 2
    status = np.zeros(l, np.int8)

    def update_status(i):
        status[i] = (UPPER if alpha[i] >= C[i] else
                     LOWER if alpha[i] <= 0 else FREE)

    active_set = np.arange(l)
    G = p.copy()
    G_bar = np.zeros(l)
    st = {"active": l, "unshrink": False}

    def swap(i, j):
        for a in (y, G, status, alpha, p, active_set, G_bar, C, QD):
            a[i], a[j] = a[j], a[i]
        Q[[i, j]] = Q[[j, i]]
        Q[:, [i, j]] = Q[:, [j, i]]

    def reconstruct():
        act = st["active"]
        if act == l:
            return
        G[act:] = G_bar[act:] + p[act:]
        free = np.flatnonzero(status[:act] == FREE)
        if len(free) * l > 2 * act * (l - act):
            for i in range(act, l):
                G[i] = _seq_sum(np.concatenate(
                    [[G[i]], alpha[free] * Q[i, free].astype(np.float64)]))
        else:
            for i in free:
                G[act:] += alpha[i] * Q[i, act:].astype(np.float64)

    def select():
        act = st["active"]
        ya, Ga, sa = y[:act], G[:act], status[:act]
        v = np.where(ya == 1, -Ga, Ga)
        cand = np.where(ya == 1, sa != UPPER, sa != LOWER)
        if not cand.any():
            return None
        Gmax = v[cand].max()
        i = int(np.flatnonzero(cand & (v == Gmax))[-1])
        Qi = Q[i, :act].astype(np.float64)
        pos = (ya == 1) & (sa != LOWER)
        neg = (ya != 1) & (sa != UPPER)
        grad_diff = np.where(pos, Gmax + Ga, Gmax - Ga)
        g2 = np.where(pos, Ga, -Ga)[pos | neg]
        Gmax2 = g2.max() if g2.size else -math.inf
        quad = np.where(pos, QD[i] + QD[:act] - 2.0 * y[i] * Qi,
                        QD[i] + QD[:act] + 2.0 * y[i] * Qi)
        obj = np.where(quad > 0, -(grad_diff * grad_diff) / np.where(
            quad > 0, quad, 1.0), -(grad_diff * grad_diff) / _TAU)
        ok = (pos | neg) & (grad_diff > 0)
        if Gmax + Gmax2 < eps or not ok.any():
            return None
        obj_min = obj[ok].min()
        return i, int(np.flatnonzero(ok & (obj == obj_min))[-1])

    def be_shrunk(i, g1, g2):
        if status[i] == UPPER:
            return -G[i] > (g1 if y[i] == 1 else g2)
        if status[i] == LOWER:
            return G[i] > (g2 if y[i] == 1 else g1)
        return False

    def shrink():
        act = st["active"]
        ya, Ga, sa = y[:act], G[:act], status[:act]
        up = np.concatenate([-Ga[(ya == 1) & (sa != UPPER)],
                             Ga[(ya != 1) & (sa != LOWER)]])
        low = np.concatenate([Ga[(ya == 1) & (sa != LOWER)],
                              -Ga[(ya != 1) & (sa != UPPER)]])
        g1 = up.max() if up.size else -math.inf
        g2 = low.max() if low.size else -math.inf
        if not st["unshrink"] and g1 + g2 <= eps * 10:
            st["unshrink"] = True
            reconstruct()
            st["active"] = l
        i = 0
        while i < st["active"]:
            if be_shrunk(i, g1, g2):
                st["active"] -= 1
                while st["active"] > i:
                    if not be_shrunk(st["active"], g1, g2):
                        swap(i, st["active"])
                        break
                    st["active"] -= 1
            i += 1

    it = 0
    counter = min(l, 1000) + 1
    while True:
        counter -= 1
        if counter == 0:
            counter = min(l, 1000)
            if shrinking:
                shrink()
        ij = select()
        if ij is None:
            reconstruct()
            st["active"] = l
            ij = select()
            if ij is None:
                break
            counter = 1
        i, j = ij
        it += 1
        act = st["active"]
        Qi = Q[i, :act].astype(np.float64)
        Qj = Q[j, :act].astype(np.float64)
        Ci, Cj = C[i], C[j]
        oi, oj = alpha[i], alpha[j]
        if y[i] != y[j]:
            quad = QD[i] + QD[j] + 2 * Qi[j]
            if quad <= 0:
                quad = _TAU
            delta = (-G[i] - G[j]) / quad
            diff = alpha[i] - alpha[j]
            alpha[i] += delta
            alpha[j] += delta
            if diff > 0:
                if alpha[j] < 0:
                    alpha[j], alpha[i] = 0, diff
            elif alpha[i] < 0:
                alpha[i], alpha[j] = 0, -diff
            if diff > Ci - Cj:
                if alpha[i] > Ci:
                    alpha[i], alpha[j] = Ci, Ci - diff
            elif alpha[j] > Cj:
                alpha[j], alpha[i] = Cj, Cj + diff
        else:
            quad = QD[i] + QD[j] - 2 * Qi[j]
            if quad <= 0:
                quad = _TAU
            delta = (G[i] - G[j]) / quad
            s = alpha[i] + alpha[j]
            alpha[i] -= delta
            alpha[j] += delta
            if s > Ci:
                if alpha[i] > Ci:
                    alpha[i], alpha[j] = Ci, s - Ci
            elif alpha[j] < 0:
                alpha[j], alpha[i] = 0, s
            if s > Cj:
                if alpha[j] > Cj:
                    alpha[j], alpha[i] = Cj, s - Cj
            elif alpha[i] < 0:
                alpha[i], alpha[j] = 0, s
        G[:act] += Qi * (alpha[i] - oi) + Qj * (alpha[j] - oj)
        ui, uj = status[i] == UPPER, status[j] == UPPER
        update_status(i)
        update_status(j)
        if ui != (status[i] == UPPER):
            G_bar[:] += (-Ci if ui else Ci) * Q[i].astype(np.float64)
        if uj != (status[j] == UPPER):
            G_bar[:] += (-Cj if uj else Cj) * Q[j].astype(np.float64)

    act = st["active"]
    yG = y[:act] * G[:act]
    sa, ya = status[:act], y[:act]
    free = sa == FREE
    ub_set = ((sa == UPPER) & (ya == -1)) | ((sa == LOWER) & (ya == 1))
    lb_set = ((sa == UPPER) & (ya == 1)) | ((sa == LOWER) & (ya == -1))
    if free.any():
        rho = _seq_sum(yG[free]) / free.sum()
    else:
        ub = yG[ub_set].min() if ub_set.any() else math.inf
        lb = yG[lb_set].max() if lb_set.any() else -math.inf
        rho = (ub + lb) / 2
    out = np.empty(l)
    out[active_set] = alpha
    return out * 1.0, rho, it


def _sigmoid_train(dec, labels):
    """libsvm's ``sigmoid_train`` (Platt scaling, Lin et al.)."""
    prior1 = float((labels > 0).sum())
    prior0 = float(len(labels)) - prior1
    hi, lo = (prior1 + 1.0) / (prior1 + 2.0), 1 / (prior0 + 2.0)
    t = [hi if v > 0 else lo for v in labels]
    dec = [float(v) for v in dec]

    def f(A, B):
        s = 0.0
        for d, ti in zip(dec, t):
            fApB = d * A + B
            if fApB >= 0:
                s += ti * fApB + math.log(1 + math.exp(-fApB))
            else:
                s += (ti - 1) * fApB + math.log(1 + math.exp(fApB))
        return s

    A, B = 0.0, math.log((prior0 + 1.0) / (prior1 + 1.0))
    fval = f(A, B)
    for _ in range(100):
        h11 = h22 = 1e-12
        h21 = g1 = g2 = 0.0
        for d, ti in zip(dec, t):
            fApB = d * A + B
            if fApB >= 0:
                p = math.exp(-fApB) / (1.0 + math.exp(-fApB))
                q = 1.0 / (1.0 + math.exp(-fApB))
            else:
                p = 1.0 / (1.0 + math.exp(fApB))
                q = math.exp(fApB) / (1.0 + math.exp(fApB))
            d2 = p * q
            h11 += d * d * d2
            h22 += d2
            h21 += d * d2
            d1 = ti - p
            g1 += d * d1
            g2 += d1
        if abs(g1) < 1e-5 and abs(g2) < 1e-5:
            break
        det = h11 * h22 - h21 * h21
        dA = -(h22 * g1 - h21 * g2) / det
        dB = -(-h21 * g1 + h11 * g2) / det
        gd = g1 * dA + g2 * dB
        step = 1.0
        while step >= 1e-10:
            newA, newB = A + step * dA, B + step * dB
            newf = f(newA, newB)
            if newf < fval + 0.0001 * step * gd:
                A, B, fval = newA, newB, newf
                break
            step = step / 2.0
        if step < 1e-10:
            break
    return A, B


def _train(X, y, gamma, C_of, eps, rng, probability, seed):
    """``svm_train`` for C-SVC on rows ``X`` with labels ``y`` (numbers);
    ``C_of(label)`` the class's C.  Returns the model dict."""
    labels = np.array(sorted(set(int(v) for v in y)))
    k = len(labels)
    perm = np.concatenate([np.flatnonzero(y == c) for c in labels])
    count = np.array([(y == c).sum() for c in labels])
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    x = X[perm]
    nonzero = np.zeros(len(y), bool)
    fs, probA, probB = [], [], []
    for i in range(k):
        for j in range(i + 1, k):
            si, sj, ci, cj = start[i], start[j], count[i], count[j]
            sx = np.concatenate([x[si:si + ci], x[sj:sj + cj]])
            sy = np.concatenate([np.ones(ci), -np.ones(cj)])
            Cp, Cn = C_of(labels[i]), C_of(labels[j])
            if probability:
                a, b = _binary_probability(sx, sy, gamma, Cp, Cn, eps, rng,
                                           seed)
                probA.append(a)
                probB.append(b)
            ys = sy.astype(np.int8)
            Q, QD = _rbf_q(sx, ys, gamma)
            C = np.where(ys > 0, Cp, Cn)
            alpha, rho, it = _solve(Q, QD, ys, C, eps)
            alpha = alpha * ys
            fs.append((alpha, rho, it))
            nonzero[si:si + ci] |= np.abs(alpha[:ci]) > 0
            nonzero[sj:sj + cj] |= np.abs(alpha[ci:]) > 0
    nSV = np.array([nonzero[start[i]:start[i] + count[i]].sum()
                    for i in range(k)])
    nz_start = np.concatenate([[0], np.cumsum(nSV)[:-1]])
    total = int(nSV.sum())
    coef = np.zeros((k - 1, total))
    p = 0
    for i in range(k):
        for j in range(i + 1, k):
            si, sj, ci, cj = start[i], start[j], count[i], count[j]
            alpha = fs[p][0]
            coef[j - 1, nz_start[i]:nz_start[i] + nSV[i]] = \
                alpha[:ci][nonzero[si:si + ci]]
            coef[i, nz_start[j]:nz_start[j] + nSV[j]] = \
                alpha[ci:][nonzero[sj:sj + cj]]
            p += 1
    return {"label": labels, "nSV": nSV, "SV": x[nonzero],
            "sv_ind": perm[nonzero], "sv_coef": coef,
            "rho": np.array([f[1] for f in fs]),
            "n_iter": np.array([f[2] for f in fs]),
            "probA": np.array(probA), "probB": np.array(probB)}


def _decision(model, X, gamma):
    """``svm_predict_values``: one-vs-one decision values of each row."""
    d = X[:, None, :] - model["SV"][None, :, :]
    kv = _exp(-gamma * _seq_sum(d * d))
    k = len(model["label"])
    start = np.concatenate([[0], np.cumsum(model["nSV"])[:-1]])
    out = []
    for i in range(k):
        for j in range(i + 1, k):
            si, sj = start[i], start[j]
            ci, cj = model["nSV"][i], model["nSV"][j]
            terms = np.concatenate(
                [np.zeros((X.shape[0], 1)),
                 model["sv_coef"][j - 1, si:si + ci] * kv[:, si:si + ci],
                 model["sv_coef"][i, sj:sj + cj] * kv[:, sj:sj + cj]], axis=1)
            out.append(_seq_sum(terms) - model["rho"][len(out)])
    return np.stack(out, axis=1)


def _binary_probability(X, y, gamma, Cp, Cn, eps, rng, seed):
    """``svm_binary_svc_probability``: a 5-fold shuffle from ``rng``, a
    sub-model per fold (which re-seeds ``rng``), Platt's fit of the
    held-out decision values."""
    l = len(y)
    perm = list(range(l))
    for i in range(l):
        j = i + rng.bounded_rand_int(l - i)
        perm[i], perm[j] = perm[j], perm[i]
    perm = np.array(perm)
    dec = np.zeros(l)
    for fold in range(5):
        begin, end = fold * l // 5, (fold + 1) * l // 5
        train = np.concatenate([perm[:begin], perm[end:]])
        held = perm[begin:end]
        pc, nc = (y[train] > 0).sum(), (y[train] <= 0).sum()
        if pc == 0 and nc == 0:
            dec[held] = 0
        elif pc > 0 and nc == 0:
            dec[held] = 1
        elif pc == 0 and nc > 0:
            dec[held] = -1
        else:
            rng.seed(seed)  # the sub-model's svm_train calls set_seed
            sub = _train(X[train], y[train], gamma,
                         lambda c: Cp if c == 1 else Cn, eps, rng, False,
                         seed)
            dec[held] = _decision(sub, X[held], gamma)[:, 0] * sub["label"][0]
    return _sigmoid_train(dec, y)


def svc_train_plain(X, y, *, gamma: float, random_seed: int) -> dict:
    """``native.svc_train`` in numpy: the same solver, shuffles and Platt
    fits, every kernel column computed up front (no cache)."""
    rng = _MT19937()
    rng.seed(random_seed)
    m = _train(np.asarray(X, np.float64), np.asarray(y, np.float64), gamma,
               lambda c: _C, _TOL, rng, True, random_seed)
    return {"support": m["sv_ind"].astype(np.int64),
            "n_support": m["nSV"].astype(np.int64),
            "dual_coef": m["sv_coef"], "intercept": -m["rho"],
            "prob_a": m["probA"], "prob_b": m["probB"],
            "n_iter": m["n_iter"].astype(np.int64), "timed_out": False}
