"""Fitting the Gaussian-process member without scikit-learn.

Counterpart of scikit-learn 1.9.0's ``GaussianProcessClassifier(kernel=1.0
* RBF(1.0), random_state=seed, warm_start=True).fit`` for three or more
classes (``gaussian_process/_gpc.py``): one-vs-rest over binary Laplace
estimators (``_BinaryGaussianProcessClassifierLaplace.fit``), each fitting
the log constant and log length scale by ``scipy.optimize.minimize(method=
"L-BFGS-B", jac=True)`` within the kernel's bounds (1e-5 to 1e5 for both)
from ``[0, 0]``, no restarts, on ``log_marginal_likelihood`` and its
gradient (GPML algorithm 5.1), whose ``_posterior_mode`` Newton loop
(algorithm 3.1, at most ``max_iter_predict=100`` steps, stopped when the
likelihood gains less than 1e-10) starts each call from the previous
call's latent values (``warm_start``).  The kernel's matrices are built
with scikit-learn's own numpy and scipy calls (``pdist``,
``squareform``, ``np.full``, ``np.dstack``), so every evaluation, and so
the optimizer's path, is the same.

The fitted state is the one ``convert._gpc_state`` reads: ``x_train``,
per binary ``y_train``, ``pi``, ``w_sr``, ``L``, ``constant`` and
``length_scale``.
"""

from __future__ import annotations

import numpy as np

#: ``ConstantKernel`` and ``RBF``'s default bounds, in log space
_BOUNDS = np.log(np.vstack([[1e-5, 1e5], [1e-5, 1e5]]))
MAX_ITER_PREDICT = 100


def kernel(X, constant, length_scale, eval_gradient: bool = False):
    """``ConstantKernel(constant) * RBF(length_scale)`` of ``X`` with
    itself (``Product.__call__``), with its gradient in log space when
    asked."""
    from scipy.spatial.distance import pdist, squareform

    X = np.atleast_2d(X)
    ls = np.squeeze(length_scale).astype(float)
    dists = pdist(X / ls, metric="sqeuclidean")
    K2 = np.exp(-0.5 * dists)
    K2 = squareform(K2)
    np.fill_diagonal(K2, 1)
    n = X.shape[0]
    dt = np.array(constant).dtype
    K1 = np.full((n, n), constant, dtype=dt)
    if not eval_gradient:
        return K1 * K2
    K2_gradient = (K2 * squareform(dists))[:, :, np.newaxis]
    K1_gradient = np.full((n, n, 1), constant, dtype=dt)
    return K1 * K2, np.dstack((K1_gradient * K2[:, :, np.newaxis],
                               K2_gradient * K1[:, :, np.newaxis]))


class _BinaryLaplace:
    """``_BinaryGaussianProcessClassifierLaplace`` with the ``1.0 *
    RBF(1.0)`` kernel and ``warm_start=True``."""

    def __init__(self, X, y01):
        self.X_train_ = np.copy(X)
        classes, self.y_train_ = np.unique(y01, return_inverse=True)
        if classes.size != 2:
            raise ValueError("a binary estimator needs 2 classes; got "
                             f"{classes.size}")
        self.constant, self.length_scale = 1.0, 1.0
        self.f_cached = None

    def _set_theta(self, theta):
        self.constant = np.exp(theta[0])
        self.length_scale = np.exp(theta[1])

    def _posterior_mode(self, K):
        from scipy.linalg import cho_solve, cholesky
        from scipy.special import expit

        if self.f_cached is not None and \
                self.f_cached.shape == self.y_train_.shape:
            f = self.f_cached
        else:
            f = np.zeros_like(self.y_train_, dtype=np.float64)
        log_marginal_likelihood = -np.inf
        for _ in range(MAX_ITER_PREDICT):
            pi = expit(f)
            W = pi * (1 - pi)
            W_sr = np.sqrt(W)
            W_sr_K = W_sr[:, np.newaxis] * K
            B = np.eye(W.shape[0]) + W_sr_K * W_sr
            L = cholesky(B, lower=True)
            b = W * f + (self.y_train_ - pi)
            a = b - W_sr * cho_solve((L, True), W_sr_K.dot(b))
            f = K.dot(a)
            lml = (-0.5 * a.T.dot(f)
                   - np.log1p(np.exp(-(self.y_train_ * 2 - 1) * f)).sum()
                   - np.log(np.diag(L)).sum())
            if lml - log_marginal_likelihood < 1e-10:
                break
            log_marginal_likelihood = lml
        self.f_cached = f
        return log_marginal_likelihood, (pi, W_sr, L, b, a)

    def log_marginal_likelihood(self, theta):
        """The likelihood at ``theta`` and its gradient (the kernel keeps
        ``theta``, as ``clone_kernel=False`` leaves it)."""
        from scipy.linalg import cho_solve, solve

        self._set_theta(theta)
        K, K_gradient = kernel(self.X_train_, self.constant,
                               self.length_scale, eval_gradient=True)
        Z, (pi, W_sr, L, b, a) = self._posterior_mode(K)
        d_Z = np.empty(theta.shape[0])
        R = W_sr[:, np.newaxis] * cho_solve((L, True), np.diag(W_sr))
        C = solve(L, W_sr[:, np.newaxis] * K)
        s_2 = (-0.5 * (np.diag(K) - np.einsum("ij, ij -> j", C, C))
               * (pi * (1 - pi) * (1 - 2 * pi)))
        for j in range(d_Z.shape[0]):
            C = K_gradient[:, :, j]
            s_1 = 0.5 * a.T.dot(C).dot(a) - 0.5 * R.T.ravel().dot(C.ravel())
            b = C.dot(self.y_train_ - pi)
            s_3 = b - K.dot(R.dot(b))
            d_Z[j] = s_1 + s_2.T.dot(s_3)
        return Z, d_Z

    def fit(self):
        import scipy.optimize

        def obj_func(theta):
            lml, grad = self.log_marginal_likelihood(theta)
            return -lml, -grad

        theta0 = np.log(np.hstack([self.constant, self.length_scale]))
        res = scipy.optimize.minimize(obj_func, theta0, method="L-BFGS-B",
                                      jac=True, bounds=_BOUNDS)
        self._set_theta(res.x)
        K = kernel(self.X_train_, self.constant, self.length_scale)
        _, (self.pi_, self.W_sr_, self.L_, _, _) = self._posterior_mode(K)
        return self


def gpc_fit(X, y, *, seed=None) -> dict:
    """``GaussianProcessClassifier(kernel=1.0 * RBF(1.0), random_state=seed,
    warm_start=True).fit(X, y)`` -> the ``gpc`` member's state.  The seed
    draws nothing: it only seeds the optimizer's restarts, of which there
    are none."""
    X = np.asarray(X)
    if X.dtype.kind not in "fiu":
        X = X.astype(np.float64)
    if X.ndim != 2 or not np.isfinite(X).all():
        raise ValueError("gpc_fit takes finite 2-D rows")
    y = np.asarray(y)
    classes = np.unique(y)
    if len(classes) < 3:
        raise ValueError("gpc_fit fits the one-vs-rest model (3 or more "
                         f"classes); got {len(classes)}")
    binaries = [_BinaryLaplace(X, (y == c).astype(np.int64)).fit()
                for c in classes]
    return {"classes": classes, "x_train": binaries[0].X_train_,
            "y_train": np.stack([b.y_train_ for b in binaries]),
            "pi": np.stack([b.pi_ for b in binaries]),
            "w_sr": np.stack([b.W_sr_ for b in binaries]),
            "L": np.stack([b.L_ for b in binaries]),
            "constant": np.asarray([float(b.constant) for b in binaries]),
            "length_scale": np.asarray([float(b.length_scale)
                                        for b in binaries])}
