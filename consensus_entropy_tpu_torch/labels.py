"""Quadrant geometry and label codecs (numpy).

Counterpart of the numpy half of ``consensus_entropy_tpu/labels.py``.  The
reference has two quadrant mappings that differ on the axes:

- AMG (``amg_test.py:69-78``): Q1 a >= 0, v >= 0; Q2 a > 0, v < 0;
  Q3 a <= 0, v <= 0; else Q4;
- DEAM (``deam_classifier.py:90-97``): Q1 a >= 0, v >= 0; Q2 a >= 0,
  v < 0; Q3 a < 0, v < 0; else Q4.
"""

from __future__ import annotations

import numpy as np

from consensus_entropy_tpu_torch.config import NUM_CLASSES, QUADRANT_TO_CLASS


def quadrant_amg_np(arousal, valence) -> np.ndarray:
    """AMG-variant quadrant as int class (Q1..Q4 -> 0..3)."""
    a = np.asarray(arousal)
    v = np.asarray(valence)
    q1 = (a >= 0) & (v >= 0)
    q2 = (a > 0) & (v < 0)
    q3 = (a <= 0) & (v <= 0)
    return np.where(q1, 0, np.where(q2, 1, np.where(q3, 2, 3))).astype(
        np.int32)


def quadrant_deam_np(arousal, valence) -> np.ndarray:
    """DEAM-variant quadrant as int class (Q1..Q4 -> 0..3)."""
    a = np.asarray(arousal)
    v = np.asarray(valence)
    q1 = (a >= 0) & (v >= 0)
    q2 = (a >= 0) & (v < 0)
    q3 = (a < 0) & (v < 0)
    return np.where(q1, 0, np.where(q2, 1, np.where(q3, 2, 3))).astype(
        np.int32)


def class_to_name(c: int) -> str:
    return f"Q{int(c) + 1}"


def names_to_classes(names) -> np.ndarray:
    """'Q1'..'Q4' -> 0..3 (``amg_test.py:54``)."""
    return np.asarray([QUADRANT_TO_CLASS[n] for n in names], dtype=np.int32)


def one_hot_np(classes, num_classes: int = NUM_CLASSES) -> np.ndarray:
    c = np.asarray(classes)
    return (c[..., None] == np.arange(num_classes)).astype(np.float32)
