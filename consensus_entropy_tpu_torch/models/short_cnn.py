"""The paper's ShortChunkCNN (the ``vgg`` trunk) in PyTorch, NCHW.

Counterpart of the vgg path of ``consensus_entropy_tpu/models/short_cnn.py``
(``ConvBlock`` ``:47-60``, ``ShortChunkCNN`` ``:173-260``, the apply
functions ``:263-367``): log-mel frontend -> BatchNorm over the 1-channel
spectrogram (``spec_bn``) -> 7 x [3x3 conv (pad 1) -> BN -> ReLU -> 2x2 max
pool] with widths 128,128,256,256,256,256,512 -> global max over (freq,
time) -> ``dense1`` -> ``head_bn`` -> ReLU -> dropout -> ``dense2`` ->
sigmoid (the reference trains with BCE on one-hot targets).

A member's variables are one flat dict of tensors with ``state_dict``
names (``blocks.{i}.conv.weight``, ``head_bn.running_var``, ...); the
forward is a function of them, so a committee runs one set of code over
many members and the trainer owns the BatchNorm statistics.

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

import torch
import torch.nn.functional as F

from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.config import CNNConfig
from consensus_entropy_tpu_torch.ops.mel import log_mel_spectrogram

BN_EPS = 1e-5
#: Flax's BatchNorm momentum: the running statistics keep 0.9 of the old
BN_MOMENTUM = 0.9
#: the Flax path and call count of the one dropout layer's key
DROPOUT_RNG_PATH = ("Dropout_0", 1)


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


def _bn_names(prefix: str) -> list[str]:
    return [f"{prefix}.{k}" for k in ("weight", "bias", "running_mean",
                                      "running_var")]


def variable_shapes(config: CNNConfig) -> dict[str, tuple]:
    """Every variable's name and shape, in forward order."""
    shapes = {}

    def bn(prefix, n):
        for name in _bn_names(prefix):
            shapes[name] = (n,)

    bn("spec_bn", 1)
    c_in = 1
    for i, width in enumerate(config.channel_widths):
        shapes[f"blocks.{i}.conv.weight"] = (width, c_in, 3, 3)
        shapes[f"blocks.{i}.conv.bias"] = (width,)
        bn(f"blocks.{i}.bn", width)
        c_in = width
    d = config.channel_widths[-1]
    shapes["dense1.weight"] = (d, d)
    shapes["dense1.bias"] = (d,)
    bn("head_bn", d)
    shapes["dense2.weight"] = (config.n_class, d)
    shapes["dense2.bias"] = (config.n_class,)
    return shapes


def is_stat(name: str) -> bool:
    """BatchNorm running statistics (Flax's ``batch_stats``), not
    parameters."""
    return ".running_" in name


def init_variables(seed: int, config: CNNConfig = CNNConfig(),
                   device=None) -> dict[str, torch.Tensor]:
    """A member's variables, as Flax initializes them: LeCun-normal
    kernels (truncated at two deviations), zero biases, BatchNorm scale 1,
    bias 0, mean 0, variance 1; drawn from a torch generator seeded with
    ``seed`` (not JAX's stream), on the CPU, then moved to ``device``."""
    from consensus_entropy_tpu_torch.device import resolve_device

    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for name, shape in variable_shapes(config).items():
        t = torch.zeros(shape, dtype=torch.float32)
        if name.endswith(("running_var", "bn.weight")):
            t.fill_(1.0)
        elif name.endswith("weight") and len(shape) > 1:
            fan_in = int(torch.tensor(shape[1:]).prod())
            std = (1.0 / fan_in) ** 0.5 / .87962566103423978
            torch.nn.init.trunc_normal_(t, std=std, a=-2 * std,
                                        b=2 * std, generator=gen)
        out[name] = t
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in out.items()}


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
    if config.arch != "vgg":
        raise NotImplementedError(f"arch {config.arch!r} (ROADMAP A8)")
    dtype = getattr(torch, config.compute_dtype)
    v = variables
    new_stats: dict = {}
    with exact_float32():
        s = log_mel_spectrogram(x, config)[:, None].to(dtype)
        s = _batch_norm(v, "spec_bn", s, train, dtype, new_stats)
        for i in range(config.n_layers):
            s = F.conv2d(s, v[f"blocks.{i}.conv.weight"].to(dtype),
                         v[f"blocks.{i}.conv.bias"].to(dtype), padding=1)
            s = _batch_norm(v, f"blocks.{i}.bn", s, train, dtype, new_stats)
            s = F.max_pool2d(F.relu(s), 2)
        s = s.amax(dim=(2, 3))
        s = _dense(v, "dense1", s, dtype)
        s = F.relu(_batch_norm(v, "head_bn", s, train, dtype, new_stats))
        if features:
            return s, new_stats
        if train and config.dropout_rate > 0:
            keep = 1.0 - config.dropout_rate
            mask = prng.bernoulli(
                prng.fold_in_static(dropout_key, *DROPOUT_RNG_PATH), keep,
                tuple(s.shape), device=s.device)
            s = torch.where(mask, s / keep, torch.zeros_like(s))
        s = _dense(v, "dense2", s, dtype)
        return torch.sigmoid(s.to(torch.float32)), new_stats


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

