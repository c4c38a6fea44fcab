"""The port's copy of the configuration it reads.

Counterpart of the parts of ``consensus_entropy_tpu/config.py`` that the
acquisition layer uses (``NUM_CLASSES``, three ``ALConfig`` fields and
``ScoringConfig``), with the same defaults and checks.  It grows as later
slices read more.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

#: The four quadrants of the valence-arousal plane (``amg_test.py:54``).
NUM_CLASSES = 4


@dataclasses.dataclass(frozen=True)
class ALConfig:
    """Active-learning parameters the acquirer and its modes read."""

    queries: int = 10  # -q
    #: qbdc: how many seeded dropout forwards of one CNN form the committee
    #: (20, like the paper's stored committee of 20 models).
    qbdc_k: int = 20
    #: wmc: EMA step of the per-member reliability-weight update.
    consensus_weight_alpha: float = 0.5

    def __post_init__(self):
        if self.qbdc_k < 1:
            raise ValueError(
                f"qbdc_k (dropout committee width) must be >= 1; "
                f"got {self.qbdc_k}")
        if not 0.0 <= self.consensus_weight_alpha <= 1.0:
            raise ValueError(
                f"consensus_weight_alpha must be in [0, 1]; "
                f"got {self.consensus_weight_alpha}")


@dataclasses.dataclass(frozen=True)
class ScoringConfig:
    """The pool-scoring step: ``pad_pool_to`` fixes the padded pool width
    across users (``Acquirer(pad_to=...)``); ``tie_break`` is the ranking's
    tie policy (``ops.topk``)."""

    pad_pool_to: int = 2048
    tie_break: Literal["numpy", "fast"] = "fast"
