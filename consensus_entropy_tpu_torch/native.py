"""The host core, in C++: the host members' predictions and the
frame-to-song mean, the boosted slot's tree build and forest predict, the
SGD member's epoch loop, scikit-learn's CART builder (the random forest,
the gradient-boosting classifier and the boosted slot's scikit-learn
member) and libsvm's C-SVC training.

Counterpart of ``consensus_entropy_tpu/native/__init__.py`` (the host
functions ``linear_predict_proba``, ``gnb_predict_proba``,
``segment_starts``, ``segment_mean`` and ``row_entropy`` ``:61-196``;
``gbdt_build_tree`` ``:199-240``, ``_gbdt_build_tree_np`` ``:242-350``,
``gbdt_predict_margins`` ``:352-402``) and of ``native/build.py:41-75``.
``native/ce_host.cpp`` and ``native/ce_gbdt.cpp`` (the port's own copies
of the JAX package's sources, whose host functions give its native build's
results bit for bit) and
``native/ce_sgd.cpp`` (scikit-learn's ``_plain_sgd`` loop, which the JAX
package takes from scikit-learn's Cython), ``native/ce_tree.cpp``
(scikit-learn's ``DepthFirstTreeBuilder`` with the best splitter) and
``native/ce_svm.cpp`` (libsvm's ``svm_train`` for ``SVC(probability=True)``,
which the JAX package reaches through scikit-learn) are compiled with the host
compiler (``g++ -O3 -fopenmp -ffp-contract=off -shared -fPIC -std=c++17``)
at first use into one library in ``consensus_entropy_tpu_torch/_build/``,
named after a hash of the sources and the flags; each process builds under
its own temporary name and moves the library into place with
``os.replace``.

Unlike the JAX package there is no silent fallback: a failed build or load
raises.  The plain versions (the JAX package's numpy fallbacks for the
host functions; numpy for the trees, the same algorithm with
the same double accumulation order, so the trees are identical; Python for
the SGD loop, ``models/members.py::plain_sgd``; Python for the CART
builder, ``models/tree_fit.py``; numpy for the SVC solver,
``models/svm_fit.py``) run only when the caller asks for them, as the
tests do.

Concurrent callers (the fleet's host workers) each cap their own OpenMP
team with :func:`limit_threads`, so four fits at once share the cores
instead of each taking all of them; the trees do not depend on it.

    python -m consensus_entropy_tpu_torch.native   # build the core
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np
from numpy.ctypeslib import ndpointer

_PKG = os.path.dirname(os.path.abspath(__file__))
HOST_SOURCE = os.path.join(_PKG, "native", "ce_host.cpp")
SOURCE = os.path.join(_PKG, "native", "ce_gbdt.cpp")
SGD_SOURCE = os.path.join(_PKG, "native", "ce_sgd.cpp")
TREE_SOURCE = os.path.join(_PKG, "native", "ce_tree.cpp")
SVM_SOURCE = os.path.join(_PKG, "native", "ce_svm.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
# no contracted multiply-adds: the plain versions round each product
CXX_FLAGS = ("-O3", "-fopenmp", "-ffp-contract=off", "-shared", "-fPIC",
             "-std=c++17")

_f32 = ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64 = ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32 = ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8 = ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u32 = ndpointer(np.uint32, flags="C_CONTIGUOUS")
_i64 = ndpointer(np.int64, flags="C_CONTIGUOUS")
_int64 = ctypes.c_int64
_pf32 = ctypes.POINTER(ctypes.c_float)

#: the jll scratch bound of ``ce_gnb_predict_proba``
MAX_CLASSES = 64
#: ``linear_predict_proba``'s modes and the core's codes for them
LINEAR_MODES = {"softmax": 0, "ova": 1}

_lib = None
#: per thread: the OpenMP team size wanted (``limit``) and the one set in
#: the library for this thread (``applied``)
_threads = threading.local()


def _sources() -> tuple[str, ...]:
    """The core's sources, read when called (tests point one elsewhere)."""
    return HOST_SOURCE, SOURCE, SGD_SOURCE, TREE_SOURCE, SVM_SOURCE


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for source in _sources():
        with open(source, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"ce_host-{digest.hexdigest()[:16]}.so")


def build() -> tuple[str, str]:
    """Compile the core unless it is built; returns ``(path, compiler
    log)``.  Raises with the compiler's output when the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, *_sources(), "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"GBDT core build failed ({' '.join(cmd)}), "
                           f"exit {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


def _get_lib() -> ctypes.CDLL:
    """The bound library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        lib.ce_linear_predict_proba.argtypes = [
            _f32, _int64, _int64, _f32, _f32, _int64, ctypes.c_int, _pf32]
        lib.ce_linear_predict_proba.restype = None
        lib.ce_gnb_predict_proba.argtypes = [
            _f32, _int64, _int64, _f64, _f64, _f64, _int64, _pf32]
        lib.ce_gnb_predict_proba.restype = None
        lib.ce_segment_mean.argtypes = [_f32, _int64, _int64, _i64, _int64,
                                        _pf32]
        lib.ce_segment_mean.restype = None
        lib.ce_row_entropy.argtypes = [_f32, _int64, _int64, _pf32]
        lib.ce_row_entropy.restype = None
        lib.ce_gbdt_build_tree.argtypes = [
            _u8, _int64, _int64, _f32, _f32, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, _i32, _i32,
            _f64]
        lib.ce_gbdt_build_tree.restype = None
        lib.ce_gbdt_predict_margins.argtypes = [
            _u8, _int64, _int64, _i32, _i32, _f64, _int64, _int64, _i32,
            _int64, ctypes.c_double, _f64]
        lib.ce_gbdt_predict_margins.restype = None
        lib.ce_gbdt_set_threads.argtypes = [ctypes.c_int]
        lib.ce_gbdt_set_threads.restype = None
        for name, ptr in (("ce_sgd_plain_f32", _f32),
                          ("ce_sgd_plain_f64", _f64)):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ctypes.POINTER(ctypes.c_double), ptr, ptr,
                           _int64, _int64, ctypes.c_uint32, ctypes.c_int,
                           ctypes.c_double, ctypes.c_double, ctypes.c_double,
                           ctypes.c_int, ctypes.c_int, ctypes.c_double, _i32,
                           ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
        lib.ce_trees_build.argtypes = [
            _f32, _int64, _int64, _f64, _int64, _f64, _int64, _int64,
            ctypes.c_int, ctypes.c_int, _int64, _int64, _u32, ctypes.c_int]
        lib.ce_trees_build.restype = ctypes.c_void_p
        lib.ce_trees_sizes.argtypes = [ctypes.c_void_p, _i64]
        lib.ce_trees_sizes.restype = None
        lib.ce_trees_copy.argtypes = [ctypes.c_void_p, _i64, _i64, _i64,
                                      _f64, _u8, _f64]
        lib.ce_trees_copy.restype = None
        lib.ce_trees_sort_counts.argtypes = [ctypes.c_void_p, _i64]
        lib.ce_trees_sort_counts.restype = None
        lib.ce_trees_free.argtypes = [ctypes.c_void_p]
        lib.ce_trees_free.restype = None
        lib.ce_multinomial_neg_gradient.argtypes = [_f64, _f64, _int64,
                                                    _int64, _f64]
        lib.ce_multinomial_neg_gradient.restype = None
        lib.ce_svc_train.argtypes = [
            _f64, _int64, _int64, _f64, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int, ctypes.c_double, _int64]
        lib.ce_svc_train.restype = ctypes.c_void_p
        lib.ce_svc_sizes.argtypes = [ctypes.c_void_p, _i64]
        lib.ce_svc_sizes.restype = None
        lib.ce_svc_copy.argtypes = [ctypes.c_void_p, _i64, _i64, _f64, _f64,
                                    _f64, _f64, _i64]
        lib.ce_svc_copy.restype = None
        lib.ce_svc_free.argtypes = [ctypes.c_void_p]
        lib.ce_svc_free.restype = None
        _lib = lib
    limit = getattr(_threads, "limit", 0)
    if limit and getattr(_threads, "applied", 0) != limit:
        _lib.ce_gbdt_set_threads(limit)
        _threads.applied = limit
    return _lib


def limit_threads(n: int) -> None:
    """Cap the OpenMP team of this thread's later calls at ``n`` (``0``:
    the OpenMP default).  Builds nothing: it takes effect at the thread's
    next call into the core."""
    _threads.limit = max(0, int(n))


def _out_ptr(out: np.ndarray):
    return out.ctypes.data_as(_pf32)


def linear_predict_proba(X, W, b, mode: str = "softmax", *,
                         plain: bool = False) -> np.ndarray:
    """Probabilities of the linear model ``X @ W + b`` (``W``: ``(f, c)``),
    float32 ``(n, c)``.  ``mode='softmax'``: multinomial; ``'ova'``:
    per-class sigmoids, L1-normalised rows (scikit-learn's one-vs-all
    ``SGDClassifier(loss='log_loss').predict_proba``), uniform where every
    sigmoid is 0.  ``plain=True`` runs the numpy version (logits in
    float64, not rounded to float32 as the core's are)."""
    X, W, b = (np.ascontiguousarray(a, np.float32) for a in (X, W, b))
    n, f = X.shape
    f2, c = W.shape
    if f2 != f or b.shape != (c,):
        raise ValueError(f"shape mismatch: X {X.shape} W {W.shape} "
                         f"b {b.shape}")
    imode = LINEAR_MODES[mode]
    if plain:
        logits = X.astype(np.float64) @ W.astype(np.float64) + b
        if imode == 0:
            logits -= logits.max(axis=1, keepdims=True)
            p = np.exp(logits)
            return (p / p.sum(axis=1, keepdims=True)).astype(np.float32)
        return ova_normalize(sigmoid(logits))
    out = np.empty((n, c), np.float32)
    _get_lib().ce_linear_predict_proba(X, n, f, W, b, c, imode,
                                       _out_ptr(out))
    return out


def sigmoid(x) -> np.ndarray:
    """Saturation-safe logistic: ``exp(-|x|)`` never overflows (it
    underflows, silently), and equals the naive form wherever that does
    not overflow, deeply negative rows included (their relative sizes
    drive the OvA normalisation)."""
    z = np.exp(-np.abs(x))
    return np.where(x >= 0, 1.0 / (1.0 + z), z / (1.0 + z))


def ova_normalize(p) -> np.ndarray:
    """scikit-learn's OvA tail: L1-normalise rows, uniform for all-zero
    rows; float32."""
    s = p.sum(axis=1, keepdims=True)
    zero = (s == 0.0).ravel()
    s[zero] = 1.0
    p = p / s
    p[zero] = 1.0 / p.shape[1]
    return p.astype(np.float32)


#: rows per block of the plain GaussianNB predict: each row's sums are its
#: own, so blocking changes no bit and keeps the float64 temporaries small
_GNB_BLOCK = 4096


def gnb_predict_proba(X, theta, var, class_prior, *,
                      plain: bool = False) -> np.ndarray:
    """GaussianNB posteriors from fitted ``theta_``/``var_``/
    ``class_prior_``: the joint log-likelihood in float64, returned as
    float32 ``(n, c)``; at most :data:`MAX_CLASSES` classes.
    ``plain=True`` runs the numpy version (the same expressions, summed
    pairwise by ``np.sum``)."""
    X = np.ascontiguousarray(X, np.float32)
    theta = np.ascontiguousarray(theta, np.float64)
    var = np.ascontiguousarray(var, np.float64)
    log_prior = np.log(np.ascontiguousarray(class_prior, np.float64))
    n, f = X.shape
    c, f2 = theta.shape
    if f2 != f or var.shape != (c, f) or log_prior.shape != (c,):
        raise ValueError(f"shape mismatch: X {X.shape} theta {theta.shape} "
                         f"var {var.shape} prior {log_prior.shape}")
    if c > MAX_CLASSES:
        raise ValueError(f"at most {MAX_CLASSES} classes (got {c})")
    out = np.empty((n, c), np.float32)
    if not plain:
        _get_lib().ce_gnb_predict_proba(X, n, f, theta, var, log_prior, c,
                                        _out_ptr(out))
        return out
    norm = [log_prior[k] - 0.5 * np.sum(np.log(2.0 * np.pi * var[k]))
            for k in range(c)]
    for lo in range(0, n, _GNB_BLOCK):
        xd = X[lo:lo + _GNB_BLOCK].astype(np.float64)
        jll = np.empty((xd.shape[0], c))
        d = np.empty_like(xd)
        for k in range(c):
            np.subtract(xd, theta[k], out=d)
            d **= 2
            d /= var[k]
            jll[:, k] = norm[k] - 0.5 * np.sum(d, axis=1)
        jll -= jll.max(axis=1, keepdims=True)
        p = np.exp(jll)
        out[lo:lo + _GNB_BLOCK] = p / p.sum(axis=1, keepdims=True)
    return out


def segment_starts(sorted_ids) -> np.ndarray:
    """Row offsets (``n_segs + 1``) of the contiguous runs of equal ids."""
    ids = np.asarray(sorted_ids)
    if ids.ndim != 1:
        raise ValueError("ids must be 1-D")
    if ids.size == 0:
        return np.zeros(1, np.int64)
    change = np.flatnonzero(ids[1:] != ids[:-1]) + 1
    return np.concatenate([[0], change, [ids.size]]).astype(np.int64)


def segment_mean(X, starts, *, plain: bool = False) -> np.ndarray:
    """The mean of ``X``'s rows within each segment
    ``[starts[s], starts[s + 1])``, summed in float64, float32
    ``(n_segs, c)``; an empty segment gives 0 (``groupby('s_id').mean()``
    on a sorted frame table, ``amg_test.py:437``).  ``plain=True`` runs
    the numpy version."""
    X = np.ascontiguousarray(X, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    n, c = X.shape
    n_segs = starts.size - 1
    if (starts[0] != 0 or starts[-1] != n
            or (n_segs > 0 and np.any(np.diff(starts) < 0))):
        raise ValueError("starts must be non-decreasing offsets from 0 to "
                         "n_rows")
    if plain:
        out = np.zeros((n_segs, c), np.float32)
        for s in range(n_segs):
            lo, hi = starts[s], starts[s + 1]
            if hi > lo:
                out[s] = X[lo:hi].mean(axis=0, dtype=np.float64)
        return out
    out = np.empty((n_segs, c), np.float32)
    _get_lib().ce_segment_mean(X, n, c, starts, n_segs, _out_ptr(out))
    return out


def row_entropy(P, *, plain: bool = False) -> np.ndarray:
    """scipy.stats.entropy of each row of ``P`` (normalised, nats,
    ``0 log 0 = 0``; a zero-sum row gives 0), float32 ``(n,)``.
    ``plain=True`` runs the numpy version."""
    P = np.ascontiguousarray(P, np.float32)
    n, c = P.shape
    if plain:
        pd = P.astype(np.float64)
        tot = pd.sum(axis=1, keepdims=True)
        q = np.divide(pd, tot, out=np.zeros_like(pd), where=tot > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            plogp = np.where(q > 0, q * np.log(q), 0.0)
        return (-plogp.sum(axis=1)).astype(np.float32)
    out = np.empty(n, np.float32)
    _get_lib().ce_row_entropy(P, n, c, _out_ptr(out))
    return out


def gbdt_build_tree(Xb, g, h, *, max_depth: int, n_bins: int,
                    lam: float = 1.0, min_child_weight: float = 1.0,
                    min_gain: float = 0.0, plain: bool = False):
    """One depth-limited regression tree on binned features.

    ``Xb``: ``(n, f)`` uint8 bin codes; ``g``/``h``: float32 gradients and
    hessians.  Returns ``(feature, threshold, value)`` in the complete-heap
    layout of ``native/ce_gbdt.cpp`` (``feature[i] == -1`` marks a leaf;
    rows with ``bin <= threshold`` descend left).  ``plain=True`` runs the
    numpy version, which builds the identical tree."""
    Xb = np.ascontiguousarray(Xb, np.uint8)
    g = np.ascontiguousarray(g, np.float32)
    h = np.ascontiguousarray(h, np.float32)
    n, f = Xb.shape
    if g.shape != (n,) or h.shape != (n,):
        raise ValueError(f"shape mismatch: Xb {Xb.shape} g {g.shape} "
                         f"h {h.shape}")
    if not 2 <= n_bins <= 256:
        raise ValueError(f"n_bins must be in [2, 256], got {n_bins}")
    if max_depth < 0:
        raise ValueError(f"max_depth must be >= 0, got {max_depth}")
    # the core indexes hist[... + code]: codes must fit in n_bins (uint8
    # cannot break this at 256 bins, so that case skips the scan)
    if n_bins < 256 and n and Xb.max() >= n_bins:
        raise ValueError(f"bin codes must be < n_bins={n_bins}; "
                         f"got max {int(Xb.max())}")
    if plain:
        return _build_tree_plain(Xb, g, h, max_depth, n_bins, lam,
                                 min_child_weight, min_gain)
    n_nodes = 2 ** (max_depth + 1) - 1
    feature = np.empty(n_nodes, np.int32)
    threshold = np.empty(n_nodes, np.int32)
    value = np.empty(n_nodes, np.float64)
    _get_lib().ce_gbdt_build_tree(Xb, n, f, g, h, max_depth, n_bins, lam,
                                  min_child_weight, min_gain, feature,
                                  threshold, value)
    return feature, threshold, value


def _build_tree_plain(Xb, g, h, max_depth, n_bins, lam, min_child_weight,
                      min_gain):
    """Level-wise histogram tree build in numpy, double accumulation in the
    core's order."""
    n, f = Xb.shape
    n_nodes = 2 ** (max_depth + 1) - 1
    feature = np.full(n_nodes, -1, np.int32)
    threshold = np.zeros(n_nodes, np.int32)
    value = np.zeros(n_nodes, np.float64)
    G = np.zeros(n_nodes)
    H = np.zeros(n_nodes)
    # cumsum's last element is the strictly sequential sum, the core's root
    # loop order (np.sum is pairwise and can flip near-tie splits)
    if n:
        G[0] = np.cumsum(g, dtype=np.float64)[-1]
        H[0] = np.cumsum(h, dtype=np.float64)[-1]
    open_ = np.zeros(n_nodes, bool)
    open_[0] = True
    node_of_row = np.zeros(n, np.int32)
    cols = np.arange(f, dtype=np.int64)
    prev_hg = prev_hh = None
    prev_local = np.full(n_nodes, -1, np.int64)

    for depth in range(max_depth):
        level = np.arange(2 ** depth - 1, 2 ** (depth + 1) - 1)
        act = level[open_[level]]
        if act.size == 0:
            break
        local = np.full(n_nodes, -1, np.int64)
        local[act] = np.arange(act.size)
        row_local = local[node_of_row]
        sel = row_local >= 0
        rl = row_local[sel]
        # sibling subtraction as the core does it: rows accumulate only for
        # the smaller child of each pair (ties: the left one); the sibling
        # is parent_hist - built_hist
        if depth == 0 or prev_hg is None:
            direct = np.ones(act.size, bool)
        else:
            counts = np.bincount(rl, minlength=act.size)
            direct = np.empty(act.size, bool)
            for a, nd in enumerate(act):
                sib = nd + 1 if nd % 2 else nd - 1
                cnt, sib_cnt = counts[a], counts[local[sib]]
                direct[a] = cnt < sib_cnt or (cnt == sib_cnt
                                              and bool(nd % 2))
        keep = direct[rl]
        idx = np.flatnonzero(sel)[keep]
        rl_k, Xl = rl[keep], Xb[idx]
        gl = g[idx].astype(np.float64)
        hl = h[idx].astype(np.float64)
        flat = ((rl_k[:, None] * f + cols[None, :]) * n_bins
                + Xl.astype(np.int64))
        size = act.size * f * n_bins
        hg = np.bincount(flat.ravel(), weights=np.repeat(gl, f),
                         minlength=size).reshape(act.size, f, n_bins)
        hh = np.bincount(flat.ravel(), weights=np.repeat(hl, f),
                         minlength=size).reshape(act.size, f, n_bins)
        for a, nd in enumerate(act):
            if direct[a]:
                continue
            sib = nd + 1 if nd % 2 else nd - 1
            parent = (nd - 1) // 2
            hg[a] = prev_hg[prev_local[parent]] - hg[local[sib]]
            hh[a] = prev_hh[prev_local[parent]] - hh[local[sib]]
        cg = np.cumsum(hg, axis=2)
        ch = np.cumsum(hh, axis=2)
        Gt = G[act][:, None, None]
        Ht = H[act][:, None, None]
        GR, HR = Gt - cg, Ht - ch
        with np.errstate(invalid="ignore"):
            gain = (cg ** 2 / (ch + lam) + GR ** 2 / (HR + lam)
                    - Gt ** 2 / (Ht + lam))
        ok = (ch >= min_child_weight) & (HR >= min_child_weight)
        ok[..., n_bins - 1] = False  # the last bin sends everything left
        # NaN gains (0/0 with lam=0 on an empty side) lose the argmax as
        # they lose the core's `gain > best`; +inf gains win in both
        gain = np.where(ok & ~np.isnan(gain), gain, -np.inf)
        gflat = gain.reshape(act.size, -1)
        best = gflat.argmax(axis=1)
        best_gain = gflat[np.arange(act.size), best]
        bf, bb = best // n_bins, best % n_bins
        for a, nd in enumerate(act):
            open_[nd] = False
            if best_gain[a] > min_gain:  # -inf: no candidate, a leaf
                feature[nd] = bf[a]
                threshold[nd] = bb[a]
                left, right = 2 * nd + 1, 2 * nd + 2
                G[left] = cg[a, bf[a], bb[a]]
                H[left] = ch[a, bf[a], bb[a]]
                G[right] = G[nd] - G[left]
                H[right] = H[nd] - H[left]
                open_[left] = open_[right] = True
            else:
                value[nd] = -G[nd] / (H[nd] + lam)
        split = feature[node_of_row] >= 0
        at_level = (node_of_row >= level[0]) & (node_of_row <= level[-1])
        move = split & at_level
        nd_m = node_of_row[move]
        go_right = (Xb[move, feature[nd_m]]
                    > threshold[nd_m].astype(np.uint8))
        node_of_row[move] = 2 * nd_m + 1 + go_right
        prev_hg, prev_hh = hg, hh
        prev_local = local
    leaves = np.flatnonzero(open_)
    value[leaves] = -G[leaves] / (H[leaves] + lam)
    return feature, threshold, value


def gbdt_predict_margins(Xb, feature, threshold, value, tree_class,
                         n_class: int, lr: float, margins=None, *,
                         plain: bool = False) -> np.ndarray:
    """Accumulate forest margins: ``margins[i, tree_class[t]] += lr *
    leaf_t(i)``.  ``feature``/``threshold``: ``(T, n_nodes)`` int32;
    ``value``: ``(T, n_nodes)`` float64.  Returns ``(n, n_class)``
    float64 (``margins`` itself when given).  ``plain=True`` runs the
    numpy version: the same sums in the same order per row."""
    Xb = np.ascontiguousarray(Xb, np.uint8)
    feature = np.ascontiguousarray(feature, np.int32)
    threshold = np.ascontiguousarray(threshold, np.int32)
    value = np.ascontiguousarray(value, np.float64)
    tree_class = np.ascontiguousarray(tree_class, np.int32)
    n, f = Xb.shape
    n_trees, n_nodes = feature.shape
    if threshold.shape != (n_trees, n_nodes) or \
            value.shape != (n_trees, n_nodes):
        raise ValueError(f"feature/threshold/value shapes disagree: "
                         f"{feature.shape} {threshold.shape} {value.shape}")
    if margins is None:
        margins = np.zeros((n, n_class), np.float64)
    elif (not isinstance(margins, np.ndarray)
          or margins.dtype != np.float64 or margins.shape != (n, n_class)
          or not margins.flags.c_contiguous):
        raise ValueError(f"margins must be C-contiguous float64 "
                         f"({n}, {n_class})")
    if n_trees == 0:
        return margins
    if tree_class.shape != (n_trees,) or (
            tree_class.min() < 0 or tree_class.max() >= n_class):
        raise ValueError(f"tree_class must be (n_trees,) indices in "
                         f"[0, {n_class}); got shape {tree_class.shape}")
    if not plain:
        _get_lib().ce_gbdt_predict_margins(
            Xb, n, f, feature, threshold, value, n_trees, n_nodes,
            tree_class, n_class, lr, margins)
        return margins
    # heap traversal, max_depth gather steps per tree, trees in order
    depth = int(np.log2(n_nodes + 1)) - 1
    rows = np.arange(n)
    for t in range(n_trees):
        node = np.zeros(n, np.int64)
        for _ in range(depth):
            fcur = feature[t, node]
            internal = fcur >= 0
            binv = Xb[rows, np.where(internal, fcur, 0)]
            child = 2 * node + 1 + (binv > threshold[t, node])
            node = np.where(internal, child, node)
        margins[:, tree_class[t]] += lr * value[t, node]
    return margins


def trees_build(X32, y, sw, seeds, *, criterion: str, n_classes: int = 1,
                max_features: int, max_depth: int,
                parallel_features: bool = False,
                plain: bool = False, sort_counts: dict | None = None) -> dict:
    """Build ``len(seeds)`` CART trees (``native/ce_tree.cpp``) on the
    float32 rows ``X32``: tree ``t`` fits ``y[t]`` with sample weights
    ``sw[t]`` (either may be one shared 1-D array), its splitter seeded
    with ``seeds[t]``; ``criterion`` is ``"gini"`` (``y`` holds class
    indices) or ``"mse"``; ``min_samples_split`` 2 and ``min_samples_leaf``
    1, scikit-learn's defaults.  Returns the trees' nodes concatenated in
    tree order (``offsets``: each tree's first node; child ids local to
    their tree, -1 at a leaf; ``feature`` -2 at a leaf) with ``value``
    ``(nodes, n_classes or 1)``.  The core
    builds the trees in parallel, or with ``parallel_features`` in turn,
    each node's features scanned in parallel: the same trees.
    ``plain=True`` runs ``models/tree_fit.py``'s Python builder, which
    builds the same trees.  ``sort_counts``, a dict, receives the core's
    ``visits`` (the feature visits the sequential loop sorts, one sort
    each) and ``sorts`` (the sorts of samples by a feature it made: at
    most twice the visits with ``parallel_features``)."""
    X32 = np.ascontiguousarray(X32, np.float32)
    n, f = X32.shape
    seeds = np.ascontiguousarray(seeds, np.uint32)
    n_trees = seeds.shape[0]
    y = np.ascontiguousarray(y, np.float64)
    sw = np.ascontiguousarray(sw, np.float64)
    for name, a in (("y", y), ("sw", sw)):
        if a.shape not in ((n,), (n_trees, n)):
            raise ValueError(f"{name} must be ({n},) or ({n_trees}, {n}); "
                             f"got {a.shape}")
    if criterion not in ("gini", "mse"):
        raise ValueError(f"criterion must be 'gini' or 'mse', got "
                         f"{criterion!r}")
    if plain:
        from consensus_entropy_tpu_torch.models.tree_fit import (
            build_trees_plain,
        )

        return build_trees_plain(
            X32, np.broadcast_to(y, (n_trees, n)),
            np.broadcast_to(sw, (n_trees, n)), seeds, criterion=criterion,
            n_classes=n_classes, max_features=max_features,
            max_depth=max_depth)
    lib = _get_lib()
    handle = lib.ce_trees_build(
        X32, n, f, y, n if y.ndim == 2 else 0, sw, n if sw.ndim == 2 else 0,
        n_trees, 0 if criterion == "gini" else 1, int(n_classes),
        int(max_features), int(max_depth), seeds,
        int(bool(parallel_features)))
    try:
        counts = np.empty(n_trees, np.int64)
        lib.ce_trees_sizes(handle, counts)
        m = int(counts.sum())
        vs = int(n_classes) if criterion == "gini" else 1
        out = {"left": np.empty(m, np.int64), "right": np.empty(m, np.int64),
               "feature": np.empty(m, np.int64),
               "threshold": np.empty(m, np.float64),
               "missing_left": np.empty(m, np.uint8),
               "value": np.empty((m, vs), np.float64)}
        lib.ce_trees_copy(handle, out["left"], out["right"], out["feature"],
                          out["threshold"], out["missing_left"],
                          out["value"])
        if sort_counts is not None:
            tally = np.empty(2, np.int64)
            lib.ce_trees_sort_counts(handle, tally)
            sort_counts.update(visits=int(tally[0]), sorts=int(tally[1]))
    finally:
        lib.ce_trees_free(handle)
    out["offsets"] = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return out


def multinomial_neg_gradient(raw, y, *, plain: bool = False) -> np.ndarray:
    """``-HalfMultinomialLoss.gradient(y, raw)``: ``(n, k)`` float64, the
    softmax of each row (max subtracted, libm ``exp``, summed in class
    order) minus the one-hot label, negated.  ``plain=True`` computes it
    in numpy with the same operations (numpy's ``exp`` may differ from
    libm's in the last bit)."""
    raw = np.ascontiguousarray(raw, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    n, k = raw.shape
    if y.shape != (n,):
        raise ValueError(f"y must be ({n},), got {y.shape}")
    if plain:
        p = np.exp(raw - raw.max(axis=1, keepdims=True))
        s = np.zeros(n)
        for c in range(k):
            s += p[:, c]
        p /= s[:, None]
        return -(p - (y[:, None] == np.arange(k)))
    out = np.empty((n, k), np.float64)
    _get_lib().ce_multinomial_neg_gradient(raw, y, n, k, out)
    return out


def svc_train(X, y, *, gamma: float, random_seed: int) -> dict:
    """libsvm's C-SVC with Platt scaling (``native/ce_svm.cpp``) on the
    float64 rows ``X`` with integer class labels ``y``, unit sample
    weights, and ``SVC()``'s other settings: C 1, tol 1e-3, shrinking, a
    200 MB kernel cache.  Returns ``support`` (row indices), ``n_support``,
    ``dual_coef``, ``intercept`` (``-rho``), ``prob_a``, ``prob_b``,
    ``n_iter`` and ``timed_out``.  The plain version is
    ``models/svm_fit.py::svc_train_plain``."""
    X = np.ascontiguousarray(X, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    n, f = X.shape
    if y.shape != (n,):
        raise ValueError(f"y must be ({n},), got {y.shape}")
    lib = _get_lib()
    handle = lib.ce_svc_train(X, n, f, y, 1.0, float(gamma), 1e-3, 1, 200.0,
                              int(random_seed))
    try:
        sizes = np.empty(3, np.int64)
        lib.ce_svc_sizes(handle, sizes)
        k, l = int(sizes[0]), int(sizes[1])
        pairs = k * (k - 1) // 2
        out = {"support": np.empty(l, np.int64),
               "n_support": np.empty(k, np.int64),
               "dual_coef": np.empty((k - 1, l), np.float64),
               "intercept": np.empty(pairs, np.float64),
               "prob_a": np.empty(pairs, np.float64),
               "prob_b": np.empty(pairs, np.float64),
               "n_iter": np.empty(pairs, np.int64)}
        lib.ce_svc_copy(handle, out["support"], out["n_support"],
                        out["dual_coef"], out["intercept"], out["prob_a"],
                        out["prob_b"], out["n_iter"])
    finally:
        lib.ce_svc_free(handle)
    out["timed_out"] = bool(sizes[2])
    return out


def plain_sgd(w: np.ndarray, intercept: float, X: np.ndarray,
              y: np.ndarray, *, seed: int, max_iter: int, t: float,
              alpha: float, tol: float, n_iter_no_change: int,
              shuffle: bool = True) -> tuple[float, int]:
    """``models/members.py::plain_sgd`` in the core: ``w`` (C-contiguous
    float32 or float64) updated in place, ``X``/``y`` in its dtype.
    Returns ``(intercept, epochs run)``; raises ``ValueError`` as the plain
    version does when the weights stop being finite."""
    dt = w.dtype
    if dt not in (np.float32, np.float64) or not w.flags.c_contiguous:
        raise ValueError(f"w must be C-contiguous float32 or float64, got "
                         f"{dt}")
    X = np.ascontiguousarray(X, dt)
    y = np.ascontiguousarray(y, dt)
    n, f = X.shape
    if w.shape != (f,) or y.shape != (n,):
        raise ValueError(f"shape mismatch: w {w.shape} X {X.shape} "
                         f"y {y.shape}")
    fn = _get_lib().ce_sgd_plain_f32 if dt == np.float32 \
        else _get_lib().ce_sgd_plain_f64
    icpt = ctypes.c_double(intercept)
    epochs = ctypes.c_int(0)
    index = np.empty(n, np.int32)
    status = fn(w, ctypes.byref(icpt), X, y, n, f, int(seed) & 0xFFFFFFFF,
                int(max_iter), float(t), float(alpha), float(tol),
                int(n_iter_no_change), int(bool(shuffle)),
                float(np.dot(w, w)), index, ctypes.byref(epochs))
    if status:
        raise ValueError(
            f"Floating-point under-/overflow occurred at epoch "
            f"#{epochs.value}. Scaling input data with StandardScaler or "
            "MinMaxScaler might help.")
    return icpt.value, epochs.value


if __name__ == "__main__":
    t0 = time.perf_counter()
    path, log = build()
    print(f"{path}: built in {time.perf_counter() - t0:.3f} s\n{log}".rstrip())
