"""The CNN members' forward pass in plain PyTorch: the log-mel frontend and
the ``vgg`` and ``res`` trunks of Won et al.'s Short-chunk CNN
(github.com/minzwon/sota-music-tagging-models, ``training/model.py``).

A frozen copy of the arithmetic, independent of the system under test.
Departures from the published model, shared with the system under test
because both follow the JAX port it was made from:

- BatchNorm follows Flax: the batch variance is ``max(0, E[x^2] -
  E[x]^2)``, biased, the running statistics move as ``0.9 old + 0.1
  batch``; eps 1e-5;
- the DFT is two matmuls against windowed cosine and sine bases (torch's
  ``stft`` is not used), centred with reflect padding, periodic Hann
  window, power 2; the mel filterbank is HTK, ``norm=None``; then
  ``10 log10(max(x, 1e-10))``.

The variables are one flat dict of tensors named as ``state_dict`` names
them (``blocks.{i}.conv.weight``, ``res_blocks.{i}.bn_proj.running_var``,
``dense1.bias``, ...).  ``tf32=True`` lets cuDNN and cuBLAS round the
convolutions' and matmuls' inputs to TF32: the lower precision the check's
control runs in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


@dataclasses.dataclass(frozen=True)
class TrunkConfig:
    arch: str = "vgg"
    n_channels: int = 128
    sample_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 256
    f_min: float = 0.0
    f_max: float = 8000.0
    n_mels: int = 128
    n_class: int = 4
    n_layers: int = 7
    input_length: int = 59049
    dropout_rate: float = 0.5

    @classmethod
    def from_dict(cls, d: dict) -> "TrunkConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def widths(self) -> tuple:
        """128, 128, 256, 256, 256, 256, 512 at the published width."""
        c, n = self.n_channels, self.n_layers
        return tuple(c if i < 2 else 2 * c if i < n - 1 else 4 * c
                     for i in range(n))

    @property
    def n_frames(self) -> int:
        return self.input_length // self.hop_length + 1


def variable_shapes(cfg: TrunkConfig) -> dict:
    """Every variable's name and shape, in forward order."""
    out = {}

    def conv(name, c_out, c_in):
        out[f"{name}.weight"] = (c_out, c_in, 3, 3)
        out[f"{name}.bias"] = (c_out,)

    def bn(name, n):
        for f in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{f}"] = (n,)

    bn("spec_bn", 1)
    c_in = 1
    for i, w in enumerate(cfg.widths):
        if cfg.arch == "res":
            p = f"res_blocks.{i}"
            conv(f"{p}.conv1", w, c_in)
            bn(f"{p}.bn1", w)
            conv(f"{p}.conv2", w, w)
            bn(f"{p}.bn2", w)
            conv(f"{p}.conv_proj", w, c_in)
            bn(f"{p}.bn_proj", w)
        elif cfg.arch == "vgg":
            conv(f"blocks.{i}.conv", w, c_in)
            bn(f"blocks.{i}.bn", w)
        else:
            raise ValueError(f"no reference trunk for arch {cfg.arch!r}")
        c_in = w
    d = cfg.widths[-1]
    out["dense1.weight"], out["dense1.bias"] = (d, d), (d,)
    bn("head_bn", d)
    out["dense2.weight"], out["dense2.bias"] = (cfg.n_class, d), (
        cfg.n_class,)
    return out


def is_stat(name: str) -> bool:
    return ".running_" in name


@contextlib.contextmanager
def precision(tf32: bool):
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


@functools.lru_cache(maxsize=4)
def _bases(n_fft: int, sample_rate: int, n_mels: int, f_min: float,
           f_max: float):
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_freqs, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
    angle = 2.0 * np.pi * np.outer(n, k) / n_fft
    cos_b = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(angle) * window[:, None]).astype(np.float32)

    def to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up)).astype(np.float32)
    return cos_b, sin_b, fb


def log_mel(x: torch.Tensor, cfg: TrunkConfig) -> torch.Tensor:
    """Waveforms ``(B, L)`` -> log-mel ``(B, n_mels, n_frames)``."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    pad = n_fft // 2
    xp = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    n_chunks = xp.shape[-1] // hop
    chunks = xp[:, : n_chunks * hop].reshape(x.shape[0], n_chunks, hop)
    frames = torch.cat([chunks[:, :-1], chunks[:, 1:]], dim=-1)
    cos_b, sin_b, fb = (torch.from_numpy(a).to(x.device) for a in _bases(
        n_fft, cfg.sample_rate, cfg.n_mels, cfg.f_min, cfg.f_max))
    re, im = frames @ cos_b, frames @ sin_b
    power = (re * re + im * im).transpose(-1, -2)
    return 10.0 * torch.log10(torch.clamp(fb.transpose(0, 1) @ power,
                                          min=1e-10))


class _Net:
    def __init__(self, v, train):
        self.v, self.train, self.new_stats = v, train, {}

    def bn(self, p, x):
        v = self.v
        axes = [a for a in range(x.ndim) if a != 1]
        shape = [1] * x.ndim
        shape[1] = x.shape[1]
        if self.train:
            mean = x.mean(axes)
            var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
            self.new_stats[f"{p}.running_mean"] = (
                BN_MOMENTUM * v[f"{p}.running_mean"]
                + (1.0 - BN_MOMENTUM) * mean)
            self.new_stats[f"{p}.running_var"] = (
                BN_MOMENTUM * v[f"{p}.running_var"]
                + (1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = v[f"{p}.running_mean"], v[f"{p}.running_var"]
        mul = torch.rsqrt(var + BN_EPS) * v[f"{p}.weight"]
        return ((x - mean.reshape(shape)) * mul.reshape(shape)
                + v[f"{p}.bias"].reshape(shape))

    def conv_bn(self, conv, bn, x, stride=1):
        y = F.conv2d(x, self.v[f"{conv}.weight"], self.v[f"{conv}.bias"],
                     stride=stride, padding=1)
        return self.bn(bn, y)


def forward(v: dict, x: torch.Tensor, cfg: TrunkConfig, *,
            train: bool = False, drop_keep=None, tf32: bool = False):
    """Sigmoid scores ``(B, C)`` of waveforms ``x`` ``(B, L)``, and the
    running statistics a train-mode pass moves.  ``drop_keep``: the
    ``(B, D)`` boolean dropout mask of a train-mode pass."""
    net = _Net(v, train)
    with precision(tf32):
        s = net.bn("spec_bn", log_mel(x, cfg)[:, None])
        for i in range(cfg.n_layers):
            if cfg.arch == "res":
                p = f"res_blocks.{i}"
                out = F.relu(net.conv_bn(f"{p}.conv1", f"{p}.bn1", s, 2))
                out = net.conv_bn(f"{p}.conv2", f"{p}.bn2", out)
                s = F.relu(net.conv_bn(f"{p}.conv_proj", f"{p}.bn_proj", s,
                                       2) + out)
            else:
                s = net.conv_bn(f"blocks.{i}.conv", f"blocks.{i}.bn", s)
                s = F.max_pool2d(F.relu(s), 2)
        s = s.amax(dim=(2, 3))
        s = F.linear(s, v["dense1.weight"], v["dense1.bias"])
        s = F.relu(net.bn("head_bn", s))
        if train and drop_keep is not None:
            keep = 1.0 - cfg.dropout_rate
            s = torch.where(drop_keep, s / keep, torch.zeros_like(s))
        s = F.linear(s, v["dense2.weight"], v["dense2.bias"])
        return torch.sigmoid(s), net.new_stats


def infer(v: dict, x: torch.Tensor, cfg: TrunkConfig, *,
          tf32: bool = False, chunk: int = 256) -> torch.Tensor:
    """Eval-mode scores ``(B, C)``, ``chunk`` crops a forward."""
    with torch.no_grad():
        return torch.cat([forward(v, x[lo: lo + chunk], cfg, tf32=tf32)[0]
                          for lo in range(0, x.shape[0], chunk)])
