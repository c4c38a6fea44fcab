"""Closed-form committee members as tensor math.

Counterpart of ``consensus_entropy_tpu/ops/device_members.py``.  The two
paper members that train by ``partial_fit`` are closed-form probabilistic
models, so scoring them over the pool needs only their parameters:

- **GaussianNB**: log prior + Gaussian log-likelihood per class, softmax;
- **SGD-logistic**: one-vs-all sigmoids of the decision function, rows
  L1-normalised (not a softmax), as sklearn's ``predict_proba``.

Every function takes one member's parameters ``(C, F)`` / ``(C,)`` or a
stack of them ``(S, C, F)`` / ``(S, C)``; a stack's products run as one
GEMM over the members' concatenated rows.  The frame->song mean is a sum
in a fixed order divided by counts (JAX: two ``segment_sum``s).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from consensus_entropy_tpu_torch.device import resolve_device


class MemberStacks(NamedTuple):
    """The device-member committee's parameters, stacked per kind: ``G``
    GaussianNB members (``theta``/``var`` ``(G, C, F)``, log prior
    ``(G, C)``) and ``S`` SGD-logistic members (``coef`` ``(S, C, F)``,
    ``intercept`` ``(S, C)``); either stack may be empty."""

    gnb_theta: torch.Tensor
    gnb_var: torch.Tensor
    gnb_log_prior: torch.Tensor
    sgd_coef: torch.Tensor
    sgd_intercept: torch.Tensor


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w[..., c, :]`` for every leading index of ``w`` ``(..., C, F)``
    as one GEMM: ``(N, F)`` -> ``(..., N, C)``."""
    *lead, c, f = w.shape
    out = x @ w.reshape(-1, f).T
    return out.reshape(x.shape[0], *lead, c).movedim(0, -2)


def gnb_log_likelihood(x: torch.Tensor, theta: torch.Tensor,
                       var: torch.Tensor,
                       log_prior: torch.Tensor) -> torch.Tensor:
    """Per-class joint log-likelihood of GaussianNB.

    x: ``(N, F)``; theta/var: ``([S,] C, F)``; log_prior: ``([S,] C)`` ->
    ``([S,] N, C)``.  The Mahalanobis term is the EXPANDED float32 form
    ``x^2 (1/var) - 2 x (theta/var) + sum theta^2/var`` the JAX function
    uses (two products in place of an ``(N, C, F)`` broadcast).  It cancels
    when ``|x| >> |x - theta|``: about 1e-3 relative to sklearn's float64
    on standardised features, so near-tie entropies can rank differently.
    """
    const = log_prior - 0.5 * torch.log(2.0 * math.pi * var).sum(dim=-1)
    inv_var = 1.0 / var
    mahal = (_project(x * x, inv_var)
             - 2.0 * _project(x, theta * inv_var)
             + (theta * theta * inv_var).sum(dim=-1)[..., None, :])
    return const[..., None, :] - 0.5 * mahal


def gnb_probs(x: torch.Tensor, theta: torch.Tensor, var: torch.Tensor,
              log_prior: torch.Tensor) -> torch.Tensor:
    """GaussianNB posterior probabilities (softmax of the JLL)."""
    return torch.softmax(gnb_log_likelihood(x, theta, var, log_prior),
                         dim=-1)


def ova_sigmoid_probs(x: torch.Tensor, coef: torch.Tensor,
                      intercept: torch.Tensor) -> torch.Tensor:
    """sklearn OvA ``SGDClassifier(loss='log_loss')`` ``predict_proba``:
    per-class sigmoid of ``x @ coef.T + intercept``, rows L1-normalised,
    uniform where a row sums to zero.

    x: ``(N, F)``; coef: ``([S,] C, F)``; intercept: ``([S,] C)`` ->
    ``([S,] N, C)``.
    """
    p = torch.sigmoid(_project(x, coef) + intercept[..., None, :])
    s = p.sum(dim=-1, keepdim=True)
    return torch.where(s > 0, p / torch.where(s > 0, s, 1.0),
                       1.0 / p.shape[-1])


def linear_softmax_probs(x: torch.Tensor, coef: torch.Tensor,
                         intercept: torch.Tensor) -> torch.Tensor:
    """Multinomial-logistic probabilities: ``softmax(x @ coef.T + b)``.

    x: ``(N, F)``; coef: ``(C, F)``; intercept: ``(C,)`` -> ``(N, C)``.
    """
    return torch.softmax(x @ coef.T + intercept, dim=-1)


def make_device_committee_scorer(frame_song_index, n_songs: int,
                                 device=None):
    """A scorer for the closed-form committee over one pool.

    ``frame_song_index``: ``(n_frames,)`` integer array mapping each pool
    frame to its song row.  Returns

        ``score(x_frames, *stacks) -> (G + S, n_songs, C)``

    per-member per-song mean probabilities on ``device``, GNB members
    first, in the order of the stacks (:class:`MemberStacks`).  The mean is
    the device analogue of ``groupby('s_id').mean()`` (``amg_test.py:437``);
    a song with no frame gives NaN, as in JAX.

    Each song's sum runs over its frames in a fixed order: a ``(n_songs,
    width)`` table of frame rows (``width`` the most frames of any song,
    short songs padded with an all-zero row) gathers them and one ``sum``
    reduces that axis.  ``index_add_`` would sum with atomics on CUDA, in
    an order that changes between passes, and so would split a near-tie
    differently when a replayed run scores the pool again.
    """
    seg = np.asarray(frame_song_index, np.int64)
    counts = np.bincount(seg, minlength=n_songs)
    width = int(counts.max(initial=0))
    order = np.argsort(seg, kind="stable")
    slot = np.arange(len(seg)) - np.repeat(np.cumsum(counts) - counts, counts)
    rows = np.full((n_songs, width), len(seg), np.int64)  # -> the zero row
    rows[seg[order], slot] = order
    dev = resolve_device(device)
    rows = torch.from_numpy(rows.reshape(-1)).to(dev)
    counts = torch.from_numpy(counts).to(dev, torch.float32)

    def score(x_frames, gnb_theta, gnb_var, gnb_log_prior, sgd_coef,
              sgd_intercept):
        frame_probs = torch.cat([
            gnb_probs(x_frames, gnb_theta, gnb_var, gnb_log_prior),
            ova_sigmoid_probs(x_frames, sgd_coef, sgd_intercept)])
        m, _, c = frame_probs.shape
        padded = torch.cat([frame_probs, frame_probs.new_zeros((m, 1, c))],
                           dim=1)
        sums = padded.index_select(1, rows).reshape(
            m, n_songs, width, c).sum(dim=2)
        return sums / counts[None, :, None]

    return score
