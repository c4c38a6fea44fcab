"""The committee-member contract.

Counterpart of ``consensus_entropy_tpu/models/base.py``: every member
scores feature rows, absorbs a labelled batch and round-trips to disk.
"""

from __future__ import annotations

import abc

import numpy as np


class Member(abc.ABC):
    """One committee member."""

    #: short algorithm tag: 'gnb', 'sgd'
    kind: str = "?"

    def __init__(self, name: str):
        self.name = name

    @abc.abstractmethod
    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        """Class probabilities ``(n, C)`` for feature rows ``X``."""

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Hard labels; default argmax of probabilities."""
        return np.argmax(self.predict_proba(X), axis=1)

    @abc.abstractmethod
    def update(self, X: np.ndarray, y: np.ndarray) -> None:
        """Absorb a labelled batch (the AL query step, ``amg_test.py:
        503-509``)."""

    @abc.abstractmethod
    def save(self, path: str) -> None: ...

    @classmethod
    @abc.abstractmethod
    def load(cls, path: str) -> "Member": ...
