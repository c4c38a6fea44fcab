"""Consensus entropy and top-q selection, in numpy.

The committee's probabilities are averaged over its members, the Shannon
entropy of each song's mean distribution is its score, and the ``q``
highest-scoring songs are queried (``mc``, the paper's mode).
"""

from __future__ import annotations

import numpy as np

#: the gap of an answer that is malformed (a pick repeated or outside the
#: pool): finite, so the result line stays JSON
WRONG = 1e9


def consensus_entropy(member_probs: np.ndarray) -> np.ndarray:
    """``(M, N, C)`` probabilities -> ``(N,)`` entropies, in float64."""
    p = np.asarray(member_probs, np.float64).mean(axis=0)
    p = p / p.sum(axis=-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        plogp = np.where(p > 0, p * np.log(np.where(p > 0, p, 1.0)), 0.0)
    return -plogp.sum(axis=-1)


def top_q(scores: np.ndarray, q: int) -> np.ndarray:
    """Indices of the ``q`` highest scores, highest first."""
    return np.argsort(-scores, kind="stable")[:q]


def selection_gap(scores: np.ndarray, chosen) -> float:
    """How far the chosen songs' scores lie below the ``len(chosen)``-th
    best score: 0 when they are the top ``len(chosen)``, ties included;
    ``WRONG`` when a chosen index repeats or lies outside the pool."""
    chosen = np.asarray(chosen, np.int64)
    if (len(set(chosen.tolist())) != len(chosen) or chosen.min() < 0
            or chosen.max() >= len(scores)):
        return WRONG
    threshold = np.sort(scores)[::-1][len(chosen) - 1]
    return float(max(0.0, np.max(threshold - scores[chosen])))


def weighted_f1(y_true, y_pred) -> float:
    """``f1_score(y_true, y_pred, average="weighted", zero_division=0)``:
    each label's F1 weighted by its count in ``y_true``."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.union1d(y_true, y_pred)
    f1 = np.zeros(len(labels))
    support = np.zeros(len(labels))
    for i, c in enumerate(labels):
        tp = np.sum((y_true == c) & (y_pred == c))
        n_pred, n_true = np.sum(y_pred == c), np.sum(y_true == c)
        p = tp / n_pred if n_pred else 0.0
        r = tp / n_true if n_true else 0.0
        f1[i] = 2 * p * r / (p + r) if p + r else 0.0
        support[i] = n_true
    return float(np.sum(f1 * support) / support.sum()) if support.sum() \
        else 0.0
