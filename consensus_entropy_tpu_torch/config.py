"""The port's copy of the configuration it reads.

Counterpart of ``consensus_entropy_tpu/config.py``: the label codec, the
openSMILE feature slice, ``PathsConfig``, ``ALConfig`` and
``ScoringConfig``, ``CNNConfig`` and ``TrainConfig``, with the same
defaults and checks (each trunk family's geometry check, with the JAX
package's messages).
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


def stft_frame_count(length: int, n_fft: int, hop: int) -> int:
    """Frames of the centered STFT: ``(length + 2*(n_fft//2)) // hop - 1``,
    231 for the 59,049-sample crop."""
    return (length + 2 * (n_fft // 2)) // hop - 1


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
    def deam_features_dir(self) -> str:
        return os.path.join(self.deam_root, "features")

    @property
    def deam_dataset_csv(self) -> str:
        """The joined frame table's cache (``data/deam.py``)."""
        return os.path.join(self.deam_root, "dataset_quads.csv")

    @property
    def deam_npy_dir(self) -> str:
        """One ``{song_id}.npy`` waveform a song (CNN pre-training)."""
        return os.path.join(self.deam_root, "npy")

    @property
    def amg_features_dir(self) -> str:
        return os.path.join(self.amg_root, "feats")

    @property
    def amg_dataset_csv(self) -> str:
        return os.path.join(self.amg_root, "dataset_feats.csv")

    @property
    def amg_npy_dir(self) -> str:
        """One ``{song_id}.npy`` waveform a song (the CNN members' audio)."""
        return os.path.join(self.amg_root, "npy")

    @property
    def amg_annotations_mat(self) -> str:
        return os.path.join(self.amg_root, "anno", "AMG1608.mat")

    @property
    def amg_mapping_mat(self) -> str:
        return os.path.join(self.amg_root, "anno", "1608_song_id.mat")


#: the trunk families (``models/short_cnn.py``)
CNN_ARCHS = ("vgg", "res", "harm", "se1d", "musicnn")


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """ShortChunkCNN hyperparameters (``short_cnn.py:284-291``,
    ``settings.py:36``); ``n_layers`` is configurable so tests can use tiny
    inputs."""

    n_channels: int = 128
    sample_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 256  # torchaudio's default, n_fft // 2
    f_min: float = 0.0
    f_max: float = 8000.0
    n_mels: int = 128
    n_class: int = NUM_CLASSES
    n_layers: int = 7
    input_length: int = 59049  # about 3.69 s at 16 kHz
    dropout_rate: float = 0.5
    #: the convolutions' and dense layers' compute dtype ("float64" serves
    #: as an oracle); parameters and BatchNorm statistics stay at least
    #: float32
    compute_dtype: str = "float32"
    #: the trunk family: ``vgg`` is the paper's ShortChunkCNN (conv, BN,
    #: ReLU, max pool blocks); ``res`` stride-2 residual blocks; ``harm``
    #: the vgg blocks over the learnable harmonic frontend; ``se1d``
    #: squeeze-excitation 1-D blocks on the raw waveform; ``musicnn``
    #: multi-shape front-end and a temporal mid-end
    arch: str = "vgg"
    #: the ``harm`` frontend's geometry
    n_harmonic: int = 6
    semitone_scale: int = 2
    bw_q_init: float = 1.0

    def __post_init__(self):
        if self.arch not in CNN_ARCHS:
            raise ValueError(f"arch must be one of {CNN_ARCHS}; got "
                             f"{self.arch!r}")
        if self.compute_dtype not in ("float32", "bfloat16", "float64"):
            raise ValueError(f"compute_dtype must be 'float32', 'bfloat16' "
                             f"or 'float64'; got {self.compute_dtype!r}")
        if self.arch == "res":
            return  # stride-2 convs ceil-halve dims; they never hit zero
        if self.arch == "musicnn":
            # the front-end keeps time; the mid-end halves it a layer
            t = self.n_frames
            for layer in range(self.n_layers):
                t //= 2
                if t == 0:
                    raise ValueError(
                        f"musicnn geometry collapses at mid-end layer "
                        f"{layer + 1}: input_length={self.input_length} "
                        f"survives only {layer} of {self.n_layers} 2x pools")
            return
        if self.arch == "se1d":
            # the stride-3 stem and a 3x max pool a block divide time by 3
            t = self.input_length // 3
            for layer in range(self.n_layers):
                t //= 3
                if t == 0:
                    raise ValueError(
                        f"se1d geometry collapses at block {layer + 1}: "
                        f"input_length={self.input_length} survives only "
                        f"{layer} of {self.n_layers} 3x pools after the "
                        f"stride-3 stem")
            return
        # the pooling pyramid must not collapse a dimension to zero; the
        # harm frontend's frequency axis is its note grid, not n_mels
        freq = self.n_mels if self.arch == "vgg" else self.harm_level
        f, t = freq, self.n_frames
        for layer in range(self.n_layers):
            f, t = f // 2, t // 2
            if f == 0 or t == 0:
                raise ValueError(
                    f"CNN geometry collapses at layer {layer + 1}: "
                    f"freq={freq}, input_length={self.input_length} "
                    f"survive only {layer} of {self.n_layers} 2x2 pools")

    @property
    def harm_level(self) -> int:
        """Frequency-axis height of the ``harm`` frontend (its note grid;
        128 at the default rate, harmonics and scale, as n_mels)."""
        from consensus_entropy_tpu_torch.ops.harmonic import (
            harmonic_center_freqs,
        )

        return harmonic_center_freqs(self.sample_rate, self.n_harmonic,
                                     self.semitone_scale)[1]

    @property
    def n_frames(self) -> int:
        return stft_frame_count(self.input_length, self.n_fft,
                                self.hop_length)

    @property
    def channel_widths(self) -> tuple[int, ...]:
        """Output channels a layer: 128,128,256,256,256,256,512 by default
        (``short_cnn.py:304-310``)."""
        return tuple(self.n_channels if i < 2 else
                     self.n_channels * 2 if i < self.n_layers - 1 else
                     self.n_channels * 4 for i in range(self.n_layers))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """CNN training hyperparameters (``settings.py:36-42``)."""

    n_epochs: int = 200  # pre-training
    n_epochs_retrain: int = 100  # AL retraining
    batch_size: int = 5
    lr: float = 1e-4
    weight_decay: float = 1e-4  # Adam's coupled L2 (amg_test.py:281)
    log_step: int = 20
    #: epochs since the last transition before each optimizer transition
    #: (``drop_counter`` resets only at transitions, ``amg_test.py:203-231``)
    adam_patience: int = 20
    sgd_patience: int = 20
    sgd_momentum: float = 0.9
    sgd_weight_decay: float = 1e-4
    sgd_lrs: tuple[float, ...] = (1e-3, 1e-4, 1e-5)


@dataclasses.dataclass(frozen=True)
class ALConfig:
    """Active-learning experiment parameters (``amg_test.py:545-573``)."""

    queries: int = 10  # -q
    epochs: int = 10  # -e
    mode: AcquisitionMode = "mc"  # -m
    num_anno: int = 150  # -n: min annotations per user
    train_size: float = 0.85  # GroupShuffleSplit (amg_test.py:363)
    seed: int = 1987  # amg_test.py:55
    #: dtype of the CNN members' per-iteration checkpoint files: bfloat16
    #: halves the bytes; loading casts back to float32, so a resumed run
    #: carries bf16-rounded weights ("float32" resumes bit for bit)
    ckpt_dtype: str = "bfloat16"
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
        if self.ckpt_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"ckpt_dtype must be 'float32' or 'bfloat16'; "
                             f"got {self.ckpt_dtype!r}")
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
