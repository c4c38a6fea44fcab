"""Operations and bytes of the CNN members' work, counted from shapes.

The forward count is a copy of the port's ``chip_smoke.cnn_work`` for the
``vgg`` and ``res`` trunks: the frontend's two DFT matmuls and the mel
matmul, each convolution's multiply-adds (2 operations each) and about 6
elementwise operations an output (BatchNorm, ReLU, pooling, the residual
sum), the two dense layers.  A training step adds the backward pass, twice
the forward's operations past the frontend (the waveform takes no
gradient).  The convolutions are also counted alone, with their bytes
(each input, output and weight byte once a call), for their roofline.

The peaks are NVIDIA's data sheet for one H100 SXM: 67 TFLOP/s in float32
outside the tensor cores (the precision the configurations state: TF32
off) and 3.35 TB/s of HBM.
"""

from __future__ import annotations

import dataclasses

from benchmark.reference.trunk import TrunkConfig

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


@dataclasses.dataclass
class Work:
    """Totals over some crops: all operations, the convolutions'
    operations, and the least time the convolutions could take."""

    flops: float = 0.0
    conv_flops: float = 0.0
    conv_bound_s: float = 0.0

    def add(self, other: "Work", times: float = 1.0) -> "Work":
        self.flops += times * other.flops
        self.conv_flops += times * other.conv_flops
        self.conv_bound_s += times * other.conv_bound_s
        return self


def convs(cfg: TrunkConfig) -> list:
    """``(c_in, c_out, n_in, n_out)`` of each 3x3 convolution of one crop:
    input and output positions."""
    out = []
    h, w, c_in = cfg.n_mels, cfg.n_frames, 1
    for width in cfg.widths:
        if cfg.arch == "res":
            ho, wo = -(-h // 2), -(-w // 2)
            out += [(c_in, width, h * w, ho * wo),
                    (width, width, ho * wo, ho * wo),
                    (c_in, width, h * w, ho * wo)]
            h, w = ho, wo
        else:
            out.append((c_in, width, h * w, h * w))
            h, w = h // 2, w // 2
        c_in = width
    return out


def forward_flops(cfg: TrunkConfig) -> tuple:
    """``(frontend, trunk)`` operations of one crop's forward."""
    t, nf = cfg.n_frames, cfg.n_fft // 2 + 1
    frontend = 2 * t * cfg.n_fft * nf * 2 + 2 * cfg.n_mels * nf * t
    trunk = sum((2 * 9 * ci + 6) * co * no for ci, co, _, no in convs(cfg))
    d = cfg.widths[-1]
    return frontend, trunk + 2 * d * d + 2 * d * cfg.n_class


def crop_work(cfg: TrunkConfig, batch: int, train: bool) -> Work:
    """One crop's work in a call of ``batch`` crops; ``train`` adds the
    backward pass (grad input and grad weight of each convolution)."""
    frontend, trunk = forward_flops(cfg)
    passes = 3 if train else 1
    flops = frontend + passes * trunk
    conv_flops = bound = 0.0
    for ci, co, ni, no in convs(cfg):
        f = 2 * 9 * ci * co * no
        act = 4 * (ci * ni + co * no)
        wgt = 4 * 9 * ci * co / batch
        conv_flops += passes * f
        bound += max(f / PEAK_FLOPS, (act + wgt) / PEAK_BYTES)
        if train:
            # grad input and grad weight: read grad out, input and weight,
            # write grad input and grad weight
            bound += max(2 * f / PEAK_FLOPS,
                         (4 * (co * no + 2 * ci * ni) + 2 * wgt)
                         / PEAK_BYTES)
    return Work(flops, conv_flops, bound)


def iteration_work(cfg: TrunkConfig, *, members: int, n_live: int,
                   n_train_q: int, n_test: int, retrain_epochs: int,
                   windows: int = 1, score_batch: int = 256,
                   batch_size: int = 5) -> Work:
    """The CNN work one AL iteration needs: the score forward over the
    live songs' crops (or their ``windows`` windows each), the retrain
    (each epoch a step a batch over the queried songs' crops, then one
    crop of each test song), and the evaluation forward over the test
    songs.  Padding crops are not counted."""
    w = Work()
    w.add(crop_work(cfg, score_batch, False), members * n_live * windows)
    w.add(crop_work(cfg, batch_size, True),
          members * retrain_epochs * n_train_q)
    w.add(crop_work(cfg, n_test, False),
          members * (retrain_epochs + 1) * n_test)
    return w


def baseline_work(cfg: TrunkConfig, *, members: int, n_test: int) -> Work:
    """A user's baseline evaluation: one forward over the test songs."""
    return Work().add(crop_work(cfg, n_test, False), members * n_test)
