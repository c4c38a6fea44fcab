"""ShortChunkCNN and its four other trunk families in PyTorch, NCHW.

Counterpart of ``consensus_entropy_tpu/models/short_cnn.py`` (``ConvBlock``
``:47-60``, ``ResBlock`` ``:62-88``, ``SEBlock1d`` ``:91-126``,
``MusicnnFrontEnd`` ``:129-170``, ``ShortChunkCNN`` ``:173-260``, the apply
functions ``:263-367``).  ``config.arch`` picks the trunk:

- ``vgg`` (the paper's member): log-mel -> BatchNorm over the 1-channel
  spectrogram (``spec_bn``) -> 7 x [3x3 conv (pad 1) -> BN -> ReLU -> 2x2
  max pool] with widths 128,128,256,256,256,256,512;
- ``res``: the same frontend, residual blocks with stride-2 downsampling
  (conv s2 -> BN -> ReLU -> conv -> BN, plus a projected shortcut conv s2
  -> BN, sum -> ReLU);
- ``harm``: the vgg blocks over the learnable harmonic frontend
  (``ops/harmonic.py``): the harmonics are input channels and the band Q
  factor ``bw_q`` is a trained parameter;
- ``se1d``: the raw waveform as ``(B, 1, L, 1)`` -> ``spec_bn`` -> a
  stride-3 stem -> squeeze-excitation residual blocks, each ending in a
  3x1 max pool;
- ``musicnn``: vertical convs over 40% and 70% of the mel axis (max over
  the rest) and horizontal 1-D convs of 32 and 64 frames over the mel
  mean, concatenated on channels, then a temporal mid-end of 3x1 convs
  and 2x1 pools.

Every trunk ends in a global max over (freq, time) -> ``dense1`` ->
``head_bn`` -> ReLU -> dropout -> ``dense2`` -> sigmoid (the reference
trains with BCE on one-hot targets).

A member's variables are one flat dict of tensors with ``state_dict``
names (``blocks.{i}.conv.weight``, ``res_blocks.{i}.bn_proj.running_var``,
...); :func:`layers` maps each to its Flax module path, so the
initializer draws each kernel under Flax's key and ``convert`` reads a
Flax tree by the same table.  The forward is a function of the dict, so
a committee runs one set of code over many members and the trainer owns
the BatchNorm statistics.

BatchNorm follows Flax, not ``torch.nn.BatchNorm``: the batch variance is
``max(0, E[x^2] - E[x]^2)``, biased, and the running statistics move as
``0.9 * old + 0.1 * batch`` with that biased variance (Flax's momentum 0.9
is torch's 0.1, and torch would fold in the unbiased variance); eps 1e-5.

``compute_dtype="float32"`` is float32: :func:`exact_float32` turns TF32
off for cuDNN's convolutions and cuBLAS's matmuls around every forward and
the trainer's backward (ROADMAP C6).  ``"bfloat16"`` casts the convolutions'
and dense layers' inputs and weights as the JAX module does; BatchNorm
statistics stay float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.config import CNNConfig
from consensus_entropy_tpu_torch.ops.harmonic import harmonic_spectrogram
from consensus_entropy_tpu_torch.ops.mel import log_mel_spectrogram

BN_EPS = 1e-5
#: Flax's BatchNorm momentum: the running statistics keep 0.9 of the old
BN_MOMENTUM = 0.9
#: the Flax path and call count of the one dropout layer's key
DROPOUT_RNG_PATH = ("Dropout_0", 1)
#: musicnn's vertical kernels span these fractions of the mel axis (7
#: frames wide), its horizontal kernels these frame counts
MUSICNN_V_FRACS, MUSICNN_V_WIDTH = (0.4, 0.7), 7
MUSICNN_H_LENGTHS = (32, 64)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the block
    (torch lets cuDNN use TF32 by default), restored after."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


@dataclasses.dataclass(frozen=True)
class Layer:
    """One layer's variables: ``kind`` ``conv`` or ``dense`` (``.weight``
    in torch's layout, ``(out, in, *kernel)``, and ``.bias``), ``bn``
    (``.weight``, ``.bias``, ``.running_mean``, ``.running_var``) or
    ``param`` (the variable ``name`` itself); ``path`` is the Flax module
    path of the layer (of the parameter, for ``param``)."""

    name: str
    kind: str
    path: tuple
    shape: tuple


def layers(config: CNNConfig) -> list[Layer]:
    """Every layer of ``config.arch``'s network, in forward order."""
    out: list[Layer] = []

    def conv(name, path, c_out, c_in, *kernel):
        out.append(Layer(name, "conv", path, (c_out, c_in, *kernel)))

    def bn(name, path, n):
        out.append(Layer(name, "bn", path, (n,)))

    widths = config.channel_widths
    if config.arch == "se1d":
        bn("spec_bn", ("spec_bn",), 1)
        conv("stem", ("stem",), widths[0], 1, 3, 1)
        bn("stem_bn", ("stem_bn",), widths[0])
        c_in = widths[0]
        for i, w in enumerate(widths):
            blk, p = f"SEBlock1d_{i}", f"se_blocks.{i}"
            conv(f"{p}.conv1", (blk, "conv1"), w, c_in, 3, 1)
            bn(f"{p}.bn1", (blk, "bn1"), w)
            conv(f"{p}.conv2", (blk, "conv2"), w, w, 3, 1)
            bn(f"{p}.bn2", (blk, "bn2"), w)
            for d in ("se_dense1", "se_dense2"):
                out.append(Layer(f"{p}.{d}", "dense", (blk, d), (w, w)))
            if c_in != w:  # the projected shortcut on a width change
                conv(f"{p}.conv_proj", (blk, "conv_proj"), w, c_in, 3, 1)
                bn(f"{p}.bn_proj", (blk, "bn_proj"), w)
            c_in = w
    elif config.arch == "musicnn":
        bn("spec_bn", ("spec_bn",), 1)
        fe, c = "MusicnnFrontEnd_0", config.n_channels
        for i, frac in enumerate(MUSICNN_V_FRACS):
            conv(f"musicnn.v{i}_conv", (fe, f"v{i}_conv"), c, 1,
                 max(1, int(config.n_mels * frac)), MUSICNN_V_WIDTH)
            bn(f"musicnn.v{i}_bn", (fe, f"v{i}_bn"), c)
        for i, length in enumerate(MUSICNN_H_LENGTHS):
            conv(f"musicnn.h{i}_conv", (fe, f"h{i}_conv"), c, 1, length)
            bn(f"musicnn.h{i}_bn", (fe, f"h{i}_bn"), c)
        c_in = c * (len(MUSICNN_V_FRACS) + len(MUSICNN_H_LENGTHS))
        for i, w in enumerate(widths):
            conv(f"mid.{i}.conv", (f"mid{i}_conv",), w, c_in, 3, 1)
            bn(f"mid.{i}.bn", (f"mid{i}_bn",), w)
            c_in = w
    else:
        c_in = 1
        if config.arch == "harm":
            out.append(Layer("bw_q", "param", ("bw_q",), (1,)))
            c_in = config.n_harmonic
        bn("spec_bn", ("spec_bn",), c_in)
        for i, w in enumerate(widths):
            if config.arch == "res":
                blk, p = f"ResBlock_{i}", f"res_blocks.{i}"
                conv(f"{p}.conv1", (blk, "conv1"), w, c_in, 3, 3)
                bn(f"{p}.bn1", (blk, "bn1"), w)
                conv(f"{p}.conv2", (blk, "conv2"), w, w, 3, 3)
                bn(f"{p}.bn2", (blk, "bn2"), w)
                conv(f"{p}.conv_proj", (blk, "conv_proj"), w, c_in, 3, 3)
                bn(f"{p}.bn_proj", (blk, "bn_proj"), w)
            else:
                blk = f"ConvBlock_{i}"
                conv(f"blocks.{i}.conv", (blk, "Conv_0"), w, c_in, 3, 3)
                bn(f"blocks.{i}.bn", (blk, "BatchNorm_0"), w)
            c_in = w
    d = widths[-1]
    out.append(Layer("dense1", "dense", ("dense1",), (d, d)))
    bn("head_bn", ("head_bn",), d)
    out.append(Layer("dense2", "dense", ("dense2",), (config.n_class, d)))
    return out


BN_FIELDS = ("weight", "bias", "running_mean", "running_var")


def layer_variables(layer: Layer) -> dict[str, tuple]:
    """The layer's variable names and shapes."""
    if layer.kind == "param":
        return {layer.name: layer.shape}
    if layer.kind == "bn":
        return {f"{layer.name}.{f}": layer.shape for f in BN_FIELDS}
    return {f"{layer.name}.weight": layer.shape,
            f"{layer.name}.bias": layer.shape[:1]}


def variable_shapes(config: CNNConfig) -> dict[str, tuple]:
    """Every variable's name and shape, in forward order."""
    return {k: v for layer in layers(config)
            for k, v in layer_variables(layer).items()}


def is_stat(name: str) -> bool:
    """BatchNorm running statistics (Flax's ``batch_stats``), not
    parameters."""
    return ".running_" in name


def kernel_from_flax(kernel) -> np.ndarray:
    """A Flax kernel (``(*spatial, in, out)``: HWIO, or ``(in, out)``) in
    torch's layout ``(out, in, *spatial)``."""
    k = np.asarray(kernel, np.float32)
    return np.ascontiguousarray(k.transpose(k.ndim - 1, k.ndim - 2,
                                            *range(k.ndim - 2)))


def _lecun_normal(key, shape: tuple, device) -> torch.Tensor:
    """Flax's default kernel init, ``lecun_normal()`` in float32 for a
    kernel of Flax's ``shape``: a normal truncated at two deviations,
    times ``sqrt(1 / fan_in) / .87962566103423978``."""
    fan_in = math.prod(shape[:-1])
    stddev = (np.sqrt(np.float32(1.0 / fan_in))
              / np.float32(.87962566103423978))
    return prng.truncated_normal(key, -2, 2, shape, device) * float(
        stddev)


def init_variables(key: torch.Tensor, config: CNNConfig = CNNConfig(),
                   device=None) -> dict[str, torch.Tensor]:
    """A member's variables as the JAX ``init_variables(key)`` (Flax's
    ``init``) makes them: each conv and dense kernel drawn in Flax's
    layout under ``fold_in_static(key, *module_path, 1)`` (its module's
    first draw), then put in torch's; biases 0, BatchNorm scale 1, bias 0,
    mean 0, variance 1; ``bw_q`` at ``config.bw_q_init``.  ``key`` is a
    threefry key (``prng.key(seed)``); the draws run on ``device``."""
    from consensus_entropy_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    out = {}
    for layer in layers(config):
        for name, shape in layer_variables(layer).items():
            out[name] = torch.zeros(shape, dtype=torch.float32, device=dev)
        if layer.kind == "param":
            out[layer.name].fill_(config.bw_q_init)
        elif layer.kind == "bn":
            out[f"{layer.name}.weight"].fill_(1.0)
            out[f"{layer.name}.running_var"].fill_(1.0)
        else:
            flax_shape = (*layer.shape[2:], layer.shape[1], layer.shape[0])
            kernel = _lecun_normal(
                prng.fold_in_static(key, *layer.path, 1), flax_shape, dev)
            n = kernel.ndim
            out[f"{layer.name}.weight"] = kernel.permute(
                n - 1, n - 2, *range(n - 2)).contiguous()
    return out


def _batch_norm(v, prefix, x, train, dtype, new_stats):
    """Flax ``BatchNorm`` over every axis but 1: statistics in at least
    float32, the output in ``dtype``; in train mode the batch's, recorded
    in ``new_stats``."""
    axes = [a for a in range(x.ndim) if a != 1]
    shape = [1] * x.ndim
    shape[1] = x.shape[1]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if train:
        mean = xf.mean(axes)
        var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
        new_stats[f"{prefix}.running_mean"] = (
            BN_MOMENTUM * v[f"{prefix}.running_mean"]
            + (1.0 - BN_MOMENTUM) * mean)
        new_stats[f"{prefix}.running_var"] = (
            BN_MOMENTUM * v[f"{prefix}.running_var"]
            + (1.0 - BN_MOMENTUM) * var)
    else:
        mean = v[f"{prefix}.running_mean"]
        var = v[f"{prefix}.running_var"]
    mul = torch.rsqrt(var + BN_EPS) * v[f"{prefix}.weight"]
    y = (xf - mean.reshape(shape)) * mul.reshape(shape)
    return (y + v[f"{prefix}.bias"].reshape(shape)).to(dtype)


def _dense(v, prefix, x, dtype):
    return F.linear(x.to(dtype), v[f"{prefix}.weight"].to(dtype),
                    v[f"{prefix}.bias"].to(dtype))


def _conv(v, prefix, x, dtype, **kw):
    """A 2-D (or, for a 3-dim weight, 1-D) convolution in ``dtype``."""
    w = v[f"{prefix}.weight"].to(dtype)
    conv = F.conv1d if w.ndim == 3 else F.conv2d
    return conv(x.to(dtype), w, v[f"{prefix}.bias"].to(dtype), **kw)


class _Trunk:
    """One forward's BatchNorm context: the variables, train mode, dtype
    and the statistics a train-mode forward moves."""

    def __init__(self, v, train, dtype):
        self.v, self.train, self.dtype = v, train, dtype
        self.new_stats: dict = {}

    def bn(self, prefix, x):
        return _batch_norm(self.v, prefix, x, self.train, self.dtype,
                           self.new_stats)

    def conv_bn(self, conv, bn, x, **kw):
        """The convolution named ``conv``, then the BatchNorm ``bn``."""
        return self.bn(bn, _conv(self.v, conv, x, self.dtype, **kw))


def _vgg_blocks(t: _Trunk, s, config):
    for i in range(config.n_layers):
        s = t.conv_bn(f"blocks.{i}.conv", f"blocks.{i}.bn", s, padding=1)
        s = F.max_pool2d(F.relu(s), 2)
    return s


def _res_blocks(t: _Trunk, s, config):
    for i in range(config.n_layers):
        p = f"res_blocks.{i}"
        out = F.relu(t.conv_bn(f"{p}.conv1", f"{p}.bn1", s, stride=2,
                               padding=1))
        out = t.conv_bn(f"{p}.conv2", f"{p}.bn2", out, padding=1)
        short = t.conv_bn(f"{p}.conv_proj", f"{p}.bn_proj", s, stride=2,
                          padding=1)
        s = F.relu(short + out)
    return s


def _se1d_trunk(t: _Trunk, x, config):
    s = t.bn("spec_bn", x[:, None, :, None].to(t.dtype))  # (B, 1, L, 1)
    s = F.relu(t.conv_bn("stem", "stem_bn", s, stride=(3, 1)))
    for i in range(config.n_layers):
        p = f"se_blocks.{i}"
        out = F.relu(t.conv_bn(f"{p}.conv1", f"{p}.bn1", s, padding=(1, 0)))
        out = t.conv_bn(f"{p}.conv2", f"{p}.bn2", out, padding=(1, 0))
        se = F.relu(_dense(t.v, f"{p}.se_dense1", out.mean(dim=(2, 3)),
                           t.dtype))
        se = torch.sigmoid(_dense(t.v, f"{p}.se_dense2", se, t.dtype))
        out = out * se[:, :, None, None]
        if f"{p}.conv_proj.weight" in t.v:
            s = t.conv_bn(f"{p}.conv_proj", f"{p}.bn_proj", s, padding=(1, 0))
        s = F.max_pool2d(F.relu(s + out), (3, 1))
    return s


def _musicnn_trunk(t: _Trunk, s, config):
    """``s``: the normalized log-mel image ``(B, 1, n_mels, T)``."""
    branches = []
    for i in range(len(MUSICNN_V_FRACS)):
        v = F.relu(t.conv_bn(f"musicnn.v{i}_conv", f"musicnn.v{i}_bn", s,
                             padding=(0, MUSICNN_V_WIDTH // 2)))
        branches.append(v.amax(dim=2))  # max over the rest of the mel axis
    avg = s.mean(dim=2)  # (B, 1, T)
    for i, length in enumerate(MUSICNN_H_LENGTHS):
        # Flax's SAME-like padding for an even kernel: one more before
        pad = length // 2
        h = F.pad(avg, (pad, pad - (length + 1) % 2))
        branches.append(F.relu(t.conv_bn(f"musicnn.h{i}_conv",
                                         f"musicnn.h{i}_bn", h)))
    n_t = min(b.shape[-1] for b in branches)
    s = torch.cat([b[..., :n_t] for b in branches], dim=1)[..., None]
    for i in range(config.n_layers):  # the temporal mid-end, /2 per stage
        s = F.relu(t.conv_bn(f"mid.{i}.conv", f"mid.{i}.bn", s,
                             padding=(1, 0)))
        s = F.max_pool2d(s, (2, 1))
    return s


def apply(variables: dict, x: torch.Tensor, config: CNNConfig = CNNConfig(),
          *, train: bool = False, dropout_key=None,
          features: bool = False):
    """The forward of waveforms ``x`` ``(B, L)``: sigmoid scores
    ``(B, C)`` float32, or with ``features`` the ``(B, D)`` input of the
    dropout layer.  Returns ``(out, new_stats)``: in train mode the batch
    statistics move the running ones (``new_stats``, the dict Flax's
    ``mutable=["batch_stats"]`` returns); in eval mode ``new_stats`` is
    empty.  Train mode draws the dropout mask from ``dropout_key`` as
    Flax's ``Dropout_0`` does."""
    dtype = getattr(torch, config.compute_dtype)
    v = variables
    t = _Trunk(v, train, dtype)
    with exact_float32():
        if config.arch == "se1d":
            s = _se1d_trunk(t, x, config)
        elif config.arch == "harm":
            s = harmonic_spectrogram(
                x, v["bw_q"], sample_rate=config.sample_rate,
                n_fft=config.n_fft, hop_length=config.hop_length,
                n_harmonic=config.n_harmonic,
                semitone_scale=config.semitone_scale).to(dtype)
            s = _vgg_blocks(t, t.bn("spec_bn", s), config)
        else:
            s = t.bn("spec_bn",
                     log_mel_spectrogram(x, config)[:, None].to(dtype))
            trunk = {"vgg": _vgg_blocks, "res": _res_blocks,
                     "musicnn": _musicnn_trunk}[config.arch]
            s = trunk(t, s, config)
        s = s.amax(dim=(2, 3))
        s = _dense(v, "dense1", s, dtype)
        s = F.relu(t.bn("head_bn", s))
        if features:
            return s, t.new_stats
        if train and config.dropout_rate > 0:
            keep = 1.0 - config.dropout_rate
            mask = prng.bernoulli(
                prng.fold_in_static(dropout_key, *DROPOUT_RNG_PATH), keep,
                tuple(s.shape), device=s.device)
            s = torch.where(mask, s / keep, torch.zeros_like(s))
        s = _dense(v, "dense2", s, dtype)
        return torch.sigmoid(s.to(torch.float32)), t.new_stats


def apply_infer(variables, x, config: CNNConfig = CNNConfig()):
    """Inference forward (running-statistics BN, no dropout): ``(B, C)``."""
    return apply(variables, x, config)[0]


def apply_train(variables, x, dropout_key, config: CNNConfig = CNNConfig()):
    """Training forward: ``(scores, new running statistics)``."""
    return apply(variables, x, config, train=True, dropout_key=dropout_key)


def apply_features(variables, x, config: CNNConfig = CNNConfig()):
    """Penultimate features ``(B, D)`` of the inference forward."""
    return apply(variables, x, config, features=True)[0]


def qbdc_infer(variables, x, mask_keys, config: CNNConfig = CNNConfig()):
    """Query-by-dropout-committee forward (arxiv 1511.06412): ``(K, B, C)``
    sigmoid scores of one member under the K dropout masks of
    ``mask_keys`` ``(K, 2)``.  Member ``j`` is the fixed subnetwork of a
    unit-level Bernoulli mask over the ``D`` features (inverted scaling),
    the same for every crop; the trunk runs once."""
    dtype = getattr(torch, config.compute_dtype)
    feats = apply_features(variables, x, config)
    kernel = variables["dense2.weight"].to(dtype)
    bias = variables["dense2.bias"].to(dtype)
    keep = 1.0 - config.dropout_rate
    outs = []
    with exact_float32():
        for key in mask_keys:
            m = prng.bernoulli(key, keep, (feats.shape[-1],),
                               device=feats.device)
            h = torch.where(m[None, :], feats / keep,
                            torch.zeros_like(feats)).to(dtype)
            outs.append(torch.sigmoid(F.linear(h, kernel, bias).to(
                torch.float32)))
    return torch.stack(outs)


def committee_infer(member_variables: list, x,
                    config: CNNConfig = CNNConfig()):
    """Every member scores the same crops: ``(M, B, C)``, one member
    after another (the JAX ``lax.map``)."""
    return torch.stack([apply_infer(v, x, config) for v in member_variables])



def committee_infer_users(user_variables: list, x,
                          config: CNNConfig = CNNConfig()):
    """Cross-user committee forward: ``(U, M, B, C)`` from one
    member-variables list per user and ``(U, B, L)`` crops, one user after
    another through :func:`committee_infer` (the JAX ``lax.map`` over
    users), so each user's rows are its own call's."""
    return torch.stack([committee_infer(v, x[u], config)
                        for u, v in enumerate(user_variables)])


def qbdc_infer_users(user_variables: list, x, mask_keys,
                     config: CNNConfig = CNNConfig()):
    """Cross-user qbdc forward: ``(U, K, B, C)`` from one member's
    variables per user, ``(U, B, L)`` crops and ``(U, K, 2)`` mask keys,
    one user after another through :func:`qbdc_infer`."""
    return torch.stack([qbdc_infer(v, x[u], mask_keys[u], config)
                        for u, v in enumerate(user_variables)])
