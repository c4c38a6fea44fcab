"""The port's copy of the configuration it reads.

Counterpart of ``consensus_entropy_tpu/config.py``: the label codec, the
openSMILE feature slice, ``PathsConfig``, ``ALConfig`` and
``ScoringConfig``, with the same defaults and checks.  The CNN and
training configurations wait for the CNN members (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Literal, Sequence

#: The paper's four acquisition modes plus the registry's qbdc and wmc.
AcquisitionMode = Literal["mc", "hc", "mix", "rand", "qbdc", "wmc"]

#: Quadrant label codec (``amg_test.py:54``).
QUADRANT_TO_CLASS = {"Q1": 0, "Q2": 1, "Q3": 2, "Q4": 3}
#: The four quadrants of the valence-arousal plane.
NUM_CLASSES = 4

#: The openSMILE column slice both datasets use (``amg_test.py:64``,
#: ``deam_classifier.py:182-185``); the newer vintage prefixes the mfcc
#: block with ``pcm_fftMag_``.
FEATURE_SLICE_START = "F0final_sma_stddev"
FEATURE_SLICE_STOP = "mfcc_sma_de[14]_amean"
FEATURE_SLICE_STOP_FFTMAG = "pcm_fftMag_mfcc_sma_de[14]_amean"
NUM_FEATURES = 260


def feature_slice(columns: Sequence[str]) -> slice:
    """Positions of the 260-column feature slice in a frame table's
    ``columns``: from ``F0final_sma_stddev`` to whichever stop column the
    table's openSMILE vintage has, both included (``DataFrame.loc``'s
    label slice in the JAX package)."""
    columns = list(columns)
    for stop in (FEATURE_SLICE_STOP_FFTMAG, FEATURE_SLICE_STOP):
        if stop in columns:
            return slice(columns.index(FEATURE_SLICE_START),
                         columns.index(stop) + 1)
    raise ValueError("unrecognized feature columns (expected the openSMILE "
                     f"slice to end at {FEATURE_SLICE_STOP!r} or "
                     f"{FEATURE_SLICE_STOP_FFTMAG!r})")


@dataclasses.dataclass(frozen=True)
class PathsConfig:
    """Dataset / model-store locations (``settings.py:11-33``)."""

    models_root: str = "./models"
    deam_root: str = "./data/deam"
    amg_root: str = "./data/amg1608"

    @property
    def pretrained_dir(self) -> str:
        return os.path.join(self.models_root, "pretrained")

    @property
    def users_dir(self) -> str:
        return os.path.join(self.models_root, "users")

    @property
    def amg_features_dir(self) -> str:
        return os.path.join(self.amg_root, "feats")

    @property
    def amg_dataset_csv(self) -> str:
        return os.path.join(self.amg_root, "dataset_feats.csv")

    @property
    def amg_annotations_mat(self) -> str:
        return os.path.join(self.amg_root, "anno", "AMG1608.mat")

    @property
    def amg_mapping_mat(self) -> str:
        return os.path.join(self.amg_root, "anno", "1608_song_id.mat")


@dataclasses.dataclass(frozen=True)
class ALConfig:
    """Active-learning experiment parameters (``amg_test.py:545-573``)."""

    queries: int = 10  # -q
    epochs: int = 10  # -e
    mode: AcquisitionMode = "mc"  # -m
    num_anno: int = 150  # -n: min annotations per user
    train_size: float = 0.85  # GroupShuffleSplit (amg_test.py:363)
    seed: int = 1987  # amg_test.py:55
    #: survivor floor for member quarantine
    min_members: int = 1
    #: bounded retry of a transient error at the scoring call site
    retry_attempts: int = 3
    retry_base_delay: float = 0.05
    #: qbdc: how many seeded dropout forwards of one CNN form the committee
    qbdc_k: int = 20
    #: wmc: ``agreement`` moves each member's weight by an EMA toward its
    #: post-reveal agreement; ``uniform`` keeps every weight at 1 (= mc)
    consensus_weighting: Literal["agreement", "uniform"] = "agreement"
    #: wmc: EMA step of the reliability-weight update
    consensus_weight_alpha: float = 0.5
    #: keep a host member's update only if its weighted F1 on the test
    #: split does not drop
    gate_host_updates: bool = False

    def __post_init__(self):
        if self.consensus_weighting not in ("agreement", "uniform"):
            raise ValueError(
                f"consensus_weighting must be 'agreement' or 'uniform'; "
                f"got {self.consensus_weighting!r}")
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
