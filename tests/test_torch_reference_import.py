"""The reference's own ShortChunkCNN weights into the port:
``convert.cnn_variables_from_reference`` against the JAX package's
``utils/torch_import.py::import_torch_shortchunk`` followed by
``convert.cnn_variables_from_jax``, on a synthetic reference-shaped state
dict (no weights are in the repository).  The variables are equal (both
paths only rename and move float32 tensors), and each refusal (wrong
arch, layer count, width, mel filterbank shape, class count) raises the
JAX importer's error.  The port's forward of the imported member is held
against a plain torch forward of the raw state dict."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from consensus_entropy_tpu.config import CNNConfig as JaxCNNConfig
from consensus_entropy_tpu.utils.torch_import import import_torch_shortchunk
from consensus_entropy_tpu_torch import convert
from consensus_entropy_tpu_torch.config import CNNConfig
from consensus_entropy_tpu_torch.models import short_cnn
from consensus_entropy_tpu_torch.ops.mel import log_mel_spectrogram

torch.set_num_threads(1)

KW = dict(n_channels=4, n_mels=32, n_layers=5, input_length=8192)
CFG, JAX_CFG = CNNConfig(**KW), JaxCNNConfig(**KW)


def _state(cfg, seed=0, n_class=4):
    """A reference-shaped state dict: random weights, moved BatchNorm
    statistics, the mel filterbank buffer and ``num_batches_tracked``."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.3):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32)
                            * scale)

    def bn(prefix, n):
        return {f"{prefix}.weight": t(n) + 1.0, f"{prefix}.bias": t(n),
                f"{prefix}.running_mean": t(n),
                f"{prefix}.running_var": torch.abs(t(n)) + 0.5,
                f"{prefix}.num_batches_tracked": torch.tensor(7)}

    state = {"spec.mel_scale.fb": t(cfg.n_fft // 2 + 1, cfg.n_mels),
             **bn("spec_bn", 1)}
    c_in = 1
    for i, width in enumerate(cfg.channel_widths):
        state[f"layer{i + 1}.conv.weight"] = t(width, c_in, 3, 3)
        state[f"layer{i + 1}.conv.bias"] = t(width)
        state.update(bn(f"layer{i + 1}.bn", width))
        c_in = width
    top = cfg.channel_widths[-1]
    state.update({"dense1.weight": t(top, top), "dense1.bias": t(top),
                  **bn("bn", top), "dense2.weight": t(n_class, top),
                  "dense2.bias": t(n_class)})
    return state


def _reference_forward(state, x, cfg):
    """The reference's eval forward from the log-mel down, torch
    functional ops over the raw state dict."""
    def bn(h, p):
        return F.batch_norm(h, state[f"{p}.running_mean"],
                            state[f"{p}.running_var"], state[f"{p}.weight"],
                            state[f"{p}.bias"], training=False, eps=1e-5)

    h = bn(log_mel_spectrogram(x, cfg)[:, None], "spec_bn")
    for i in range(cfg.n_layers):
        h = F.conv2d(h, state[f"layer{i + 1}.conv.weight"],
                     state[f"layer{i + 1}.conv.bias"], padding=1)
        h = F.max_pool2d(F.relu(bn(h, f"layer{i + 1}.bn")), 2)
    h = h.amax(dim=(2, 3))
    h = F.relu(bn(F.linear(h, state["dense1.weight"], state["dense1.bias"]),
                  "bn"))
    return torch.sigmoid(F.linear(h, state["dense2.weight"],
                                  state["dense2.bias"]))


@pytest.mark.parametrize("seed, with_fb", [(0, True), (1, False)])
def test_reference_state_imports_as_jax_does(seed, with_fb):
    state = _state(CFG, seed)
    if not with_fb:
        del state["spec.mel_scale.fb"]
    ours = convert.cnn_variables_from_reference(state, CFG, "cpu")
    ref = convert.cnn_variables_from_jax(
        import_torch_shortchunk(state, JAX_CFG), CFG, "cpu")
    assert list(ours) == list(ref) == list(short_cnn.variable_shapes(CFG))
    for k, t in ours.items():
        assert torch.equal(t, ref[k]), k
    # numpy arrays read as tensors do
    as_np = convert.cnn_variables_from_reference(
        {k: v.numpy() for k, v in state.items()}, CFG, "cpu")
    assert all(torch.equal(as_np[k], t) for k, t in ours.items())
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (3, CFG.input_length)).astype(np.float32) * 0.1)
    np.testing.assert_allclose(
        short_cnn.apply_infer(ours, x, CFG).numpy(),
        _reference_forward(state, x, CFG).numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("what, kw, edit", [
    ("arch", dict(KW, arch="res"), None),
    ("layer count", dict(KW, n_layers=4), None),
    ("width", dict(KW, n_channels=8), None),
    ("mel filterbank", KW, ("spec.mel_scale.fb", (257, 96))),
    ("mel geometry", dict(KW, n_mels=64, input_length=16384), None),
    ("class count", dict(KW, n_class=3), None),
])
def test_reference_import_refusals_are_jaxs(what, kw, edit):
    state = _state(CFG)
    if edit is not None:
        state[edit[0]] = torch.zeros(edit[1])
    with pytest.raises(ValueError) as ours:
        convert.cnn_variables_from_reference(state, CNNConfig(**kw), "cpu")
    with pytest.raises(ValueError) as theirs:
        import_torch_shortchunk(state, JaxCNNConfig(**kw))
    assert str(ours.value) == str(theirs.value), what
