"""Gradient-boosted trees with true continued boosting: the ``xgb`` slot.

Counterpart of ``consensus_entropy_tpu/models/gbdt.py:41-271``.  The
reference continues its ``XGBClassifier(max_depth=5)`` each AL iteration
with ``fit(X, y, xgb_model=booster)`` under a patch that keeps the 4-class
softprob objective (``amg_test.py:507``): new rounds are fit on the raw
query batch, even when the batch lacks classes.

- :class:`QuantileBinner`: per-feature quantile edges, fit once; codes
  count the edges strictly below a value (``searchsorted`` side
  ``left``: bins are ``(lo, hi]``).
- :class:`GBDT`: K-class softmax boosting, one depth-limited histogram
  tree per class per round, ``K`` pinned so a class-deficient batch still
  boosts every class.
- :class:`NativeGBDTMember`: the committee member; ``fit`` retrains from
  scratch (fresh binner), ``update`` boosts on the batch.  Its files are
  the port's ``.npz`` with a CRC32 trailer.

The tree build and forest predict run in the port's host core
(``consensus_entropy_tpu_torch.native``).
"""

from __future__ import annotations

import numpy as np

from consensus_entropy_tpu_torch import native
from consensus_entropy_tpu_torch.config import NUM_CLASSES
from consensus_entropy_tpu_torch.models.base import (
    Member,
    _read_npz,
    _require_all_classes,
    _write_npz,
)


class QuantileBinner:
    """Per-feature quantile binning to uint8 codes (at most ``n_bins - 1``
    interior edges a feature)."""

    def __init__(self, n_bins: int = 256):
        if not 2 <= n_bins <= 256:
            raise ValueError(f"n_bins must be in [2, 256], got {n_bins}")
        self.n_bins = n_bins
        self.edges: list[np.ndarray] | None = None

    def fit(self, X) -> "QuantileBinner":
        X = np.asarray(X, np.float64)
        qs = np.linspace(0.0, 1.0, self.n_bins + 1)[1:-1]
        self.edges = [np.unique(np.quantile(X[:, j], qs)).astype(np.float64)
                      for j in range(X.shape[1])]
        return self

    def transform(self, X) -> np.ndarray:
        if self.edges is None:
            raise RuntimeError("binner not fitted")
        X = np.asarray(X, np.float64)
        if X.shape[1] != len(self.edges):
            raise ValueError(f"expected {len(self.edges)} features, "
                             f"got {X.shape[1]}")
        out = np.empty(X.shape, np.uint8)
        for j, e in enumerate(self.edges):
            out[:, j] = np.searchsorted(e, X[:, j], side="left")
        return np.ascontiguousarray(out)


class GBDT:
    """K-class softmax gradient boosting over binned features: one tree per
    class per round (xgboost's multi:softprob layout), Newton leaves
    ``-G/(H+lambda)`` scaled by ``learning_rate``."""

    def __init__(self, n_class: int, *, max_depth: int = 5,
                 learning_rate: float = 0.3, lam: float = 1.0,
                 min_child_weight: float = 1.0, min_gain: float = 0.0,
                 n_bins: int = 256):
        self.n_class = n_class
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.lam = lam
        self.min_child_weight = min_child_weight
        self.min_gain = min_gain
        self.n_bins = n_bins
        n_nodes = 2 ** (max_depth + 1) - 1
        self._feature = np.empty((0, n_nodes), np.int32)
        self._threshold = np.empty((0, n_nodes), np.int32)
        self._value = np.empty((0, n_nodes), np.float64)
        self._tree_class = np.empty(0, np.int32)

    @property
    def n_trees(self) -> int:
        return self._feature.shape[0]

    def margins(self, Xb) -> np.ndarray:
        """Raw scores ``(n, K)`` of the current forest."""
        return native.gbdt_predict_margins(
            Xb, self._feature, self._threshold, self._value,
            self._tree_class, self.n_class, self.learning_rate)

    def predict_proba(self, Xb) -> np.ndarray:
        m = self.margins(Xb)
        m -= m.max(axis=1, keepdims=True)
        p = np.exp(m)
        return (p / p.sum(axis=1, keepdims=True)).astype(np.float32)

    def boost(self, Xb, y, n_rounds: int) -> "GBDT":
        """Add ``n_rounds`` x K trees fit on ``(Xb, y)``, starting from the
        forest's margins on ``Xb`` (continued boosting).  ``y`` may lack
        classes: absent classes keep zero one-hot targets."""
        if n_rounds <= 0:
            raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
        Xb = np.ascontiguousarray(Xb, np.uint8)
        y = np.asarray(y, np.int64)
        if len(y) and (y.min() < 0 or y.max() >= self.n_class):
            raise ValueError(f"labels must be in [0, {self.n_class}); got "
                             f"range [{y.min()}, {y.max()}]")
        onehot = np.zeros((len(y), self.n_class), np.float64)
        onehot[np.arange(len(y)), y] = 1.0
        m = self.margins(Xb)
        new_f, new_t, new_v, new_c = [], [], [], []
        for _ in range(n_rounds):
            z = m - m.max(axis=1, keepdims=True)
            p = np.exp(z)
            p /= p.sum(axis=1, keepdims=True)
            for k in range(self.n_class):
                g = (p[:, k] - onehot[:, k]).astype(np.float32)
                h = np.maximum(p[:, k] * (1.0 - p[:, k]),
                               1e-16).astype(np.float32)
                f_, t_, v_ = native.gbdt_build_tree(
                    Xb, g, h, max_depth=self.max_depth, n_bins=self.n_bins,
                    lam=self.lam, min_child_weight=self.min_child_weight,
                    min_gain=self.min_gain)
                new_f.append(f_)
                new_t.append(t_)
                new_v.append(v_)
                new_c.append(k)
                m[:, k] += self.learning_rate * native.gbdt_predict_margins(
                    Xb, f_[None], t_[None], v_[None],
                    np.zeros(1, np.int32), 1, 1.0)[:, 0]
        self._feature = np.concatenate([self._feature, np.stack(new_f)])
        self._threshold = np.concatenate([self._threshold, np.stack(new_t)])
        self._value = np.concatenate([self._value, np.stack(new_v)])
        self._tree_class = np.concatenate(
            [self._tree_class, np.asarray(new_c, np.int32)])
        return self

    #: scalar hyperparameters, in the JAX ``state()`` dict's names
    HYPER = ("n_class", "max_depth", "learning_rate", "lam",
             "min_child_weight", "min_gain", "n_bins")

    def state(self) -> dict:
        return {**{k: getattr(self, k) for k in self.HYPER},
                "feature": self._feature, "threshold": self._threshold,
                "value": self._value, "tree_class": self._tree_class}

    @classmethod
    def from_state(cls, st: dict) -> "GBDT":
        obj = cls(int(st["n_class"]), max_depth=int(st["max_depth"]),
                  learning_rate=float(st["learning_rate"]),
                  lam=float(st["lam"]),
                  min_child_weight=float(st["min_child_weight"]),
                  min_gain=float(st["min_gain"]), n_bins=int(st["n_bins"]))
        obj._feature = np.ascontiguousarray(st["feature"], np.int32)
        obj._threshold = np.ascontiguousarray(st["threshold"], np.int32)
        obj._value = np.ascontiguousarray(st["value"], np.float64)
        obj._tree_class = np.ascontiguousarray(st["tree_class"], np.int32)
        return obj


class NativeGBDTMember(Member):
    """The boosted committee member: max_depth 5, 100 rounds at eta 0.3
    (``deam_classifier.py:226-231``, xgboost's defaults); ``update`` adds
    ``update_estimators`` rounds on the raw query batch."""

    kind = "xgb"

    def __init__(self, name: str = "xgb", *, max_depth: int = 5,
                 n_estimators: int = 100, update_estimators: int | None = None,
                 learning_rate: float = 0.3, n_bins: int = 256):
        super().__init__(name)
        self.n_estimators = n_estimators
        self.update_estimators = (n_estimators if update_estimators is None
                                  else update_estimators)
        self.binner = QuantileBinner(n_bins)
        self.model = GBDT(NUM_CLASSES, max_depth=max_depth,
                          learning_rate=learning_rate, n_bins=n_bins)

    def fit(self, X, y):
        """Retrain from scratch: fresh bin edges and a fresh forest."""
        y = np.asarray(y)
        _require_all_classes(y)
        X = np.asarray(X)
        self.binner = QuantileBinner(self.binner.n_bins)
        self.model = GBDT(NUM_CLASSES, max_depth=self.model.max_depth,
                          learning_rate=self.model.learning_rate,
                          n_bins=self.model.n_bins)
        self.binner.fit(X)
        self.model.boost(self.binner.transform(X), y, self.n_estimators)
        return self

    def update(self, X, y):
        """Continued boosting on the raw batch (no class padding)."""
        self.model.boost(self.binner.transform(np.asarray(X)),
                         np.asarray(y), self.update_estimators)

    def predict_proba(self, X):
        return self.model.predict_proba(self.binner.transform(np.asarray(X)))

    def predict(self, X):
        return np.argmax(self.predict_proba(X), axis=1)

    @classmethod
    def from_state(cls, st: dict) -> "NativeGBDTMember":
        """From the JAX member's pickled state dict (``fmt``
        ``native_gbdt``) or this class's own."""
        obj = cls.__new__(cls)
        Member.__init__(obj, st["name"])
        obj.n_estimators = int(st["n_estimators"])
        obj.update_estimators = int(st["update_estimators"])
        obj.binner = QuantileBinner(int(st["n_bins"]))
        obj.binner.edges = (None if st["edges"] is None else
                            [np.asarray(e, np.float64) for e in st["edges"]])
        obj.model = GBDT.from_state(st["model"])
        return obj

    def save(self, path: str) -> None:
        model = self.model.state()
        edges = self.binner.edges
        meta = {"kind": self.kind, "name": self.name,
                "n_estimators": self.n_estimators,
                "update_estimators": self.update_estimators,
                "n_bins": self.binner.n_bins, "fitted": edges is not None,
                **{k: model[k] for k in GBDT.HYPER}}
        arrays = {k: model[k] for k in ("feature", "threshold", "value",
                                        "tree_class")}
        # ragged edges: one flat array and each feature's count
        arrays["edges"] = (np.concatenate(edges) if edges else
                           np.empty(0, np.float64))
        arrays["edge_counts"] = np.array([len(e) for e in edges or []],
                                         np.int64)
        _write_npz(path, meta, arrays)

    @classmethod
    def load(cls, path: str) -> "NativeGBDTMember":
        meta, a = _read_npz(path)
        edges = None
        if meta["fitted"]:
            edges = np.split(a["edges"], np.cumsum(a["edge_counts"])[:-1])
        return cls.from_state({
            "name": meta["name"], "n_estimators": meta["n_estimators"],
            "update_estimators": meta["update_estimators"],
            "n_bins": meta["n_bins"], "edges": edges,
            "model": {**{k: meta[k] for k in GBDT.HYPER},
                      **{k: a[k] for k in ("feature", "threshold", "value",
                                           "tree_class")}}})
