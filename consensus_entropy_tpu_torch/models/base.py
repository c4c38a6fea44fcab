"""The committee-member contract.

Counterpart of ``consensus_entropy_tpu/models/base.py``: every member
scores feature rows, absorbs a labelled batch and round-trips to disk.
"""

from __future__ import annotations

import abc
import io
import json
import os
import zlib

import numpy as np

from consensus_entropy_tpu_torch.config import NUM_CLASSES


class Member(abc.ABC):
    """One committee member."""

    #: short algorithm tag: 'gnb', 'sgd', 'xgb', 'cnn'
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


def _require_all_classes(y):
    """Pre-training must expose the full class universe."""
    seen = np.unique(y)
    if len(seen) != NUM_CLASSES:
        raise ValueError(
            f"pre-training data must contain all {NUM_CLASSES} classes; "
            f"got {sorted(int(c) for c in seen)}")


def _write_npz(path: str, meta: dict, arrays: dict) -> None:
    """An ``.npz`` archive (the arrays and a JSON header) followed by the
    CRC32 of its bytes, so bit-rot anywhere in the file is caught on
    load.  Written to ``path + ".tmp"`` and renamed over ``path``, as the
    JAX checkpoint writer does: a file under ``path`` is whole, and a
    process killed mid-write leaves only the ``.tmp``, which no reader
    takes for a member."""
    buf = io.BytesIO()
    np.savez(buf, meta=np.array(json.dumps(meta)), **arrays)
    body = buf.getvalue()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(body + zlib.crc32(body).to_bytes(4, "little"))
    os.replace(tmp, path)


def _read_npz(path: str) -> tuple[dict, dict]:
    with open(path, "rb") as f:
        data = f.read()
    body, crc = data[:-4], data[-4:]
    if len(data) < 4 or zlib.crc32(body).to_bytes(4, "little") != crc:
        raise ValueError(f"{path}: member file fails its CRC32")
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "meta"}
        meta = json.loads(str(z["meta"]))
    return meta, arrays
