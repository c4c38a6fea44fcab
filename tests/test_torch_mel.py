"""The port's log-mel frontend against the JAX package's, on the CPU.

The filterbank and the windowed DFT bases are the same numpy code (equal
bit for bit); framing is data movement (equal bit for bit); the power and
log-mel spectrograms run as float32 matmuls summed in XLA's order on one
side and torch's on the other, so they are held to JAX within rtol 1e-5 /
atol 1e-4 dB (power: rtol 1e-5, atol 1e-6 of the largest bin).  The
port's float64 run is held to a numpy float64 oracle (``rfft``, exact
window) within 1e-4 dB: the DFT bases are float32 constants in both
packages, which bounds how close it can come."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_entropy_tpu.config import CNNConfig as JaxCNNConfig
from consensus_entropy_tpu.ops import mel as jax_mel
from consensus_entropy_tpu_torch.config import CNNConfig
from consensus_entropy_tpu_torch.ops import mel

torch.set_num_threads(1)

TOL = {"rtol": 1e-5, "atol": 1e-4}


@pytest.mark.parametrize("args", [
    (16000, 512, 128, 0.0, 8000.0),
    (22050, 1024, 96, 20.0, 11025.0),
    (16000, 256, 32, 0.0, 8000.0),
])
def test_filterbank_matches_jax(args):
    ours = mel.mel_filterbank(*args)
    np.testing.assert_array_equal(ours, jax_mel.mel_filterbank(*args))
    assert ours.shape == (args[1] // 2 + 1, args[2])
    assert ours.dtype == np.float32 and ours.min() >= 0


@pytest.mark.parametrize("n_fft", [256, 512])
def test_dft_bases_match_jax(n_fft):
    for a, b in zip(mel._dft_bases(n_fft), jax_mel._dft_bases(n_fft)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("length", [8192, 8500, 59049])
def test_framing_matches_jax(length):
    x = np.random.default_rng(length).standard_normal(
        (2, length)).astype(np.float32)
    frames, n = mel.frame_signal(torch.from_numpy(x), 512, 256)
    ref, n_ref = jax_mel.frame_signal(jnp.asarray(x), 512, 256)
    assert n == n_ref
    np.testing.assert_array_equal(frames.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="hop"):
        mel.frame_signal(torch.from_numpy(x), 512, 128)


def _oracle_log_mel(x, cfg):
    """float64 numpy of the same definition (reflect padding, periodic
    Hann, |rfft|^2, HTK mel, 10 log10)."""
    pad = cfg.n_fft // 2
    xp = np.pad(x.astype(np.float64), [(0, 0), (pad, pad)], mode="reflect")
    n_frames = cfg.n_frames
    idx = (np.arange(n_frames)[:, None] * cfg.hop_length
           + np.arange(cfg.n_fft)[None])
    win = 0.5 * (1 - np.cos(2 * np.pi * np.arange(cfg.n_fft) / cfg.n_fft))
    spec = np.abs(np.fft.rfft(xp[:, idx] * win, axis=-1)) ** 2
    fb = mel.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                            cfg.f_min, cfg.f_max).astype(np.float64)
    return 10 * np.log10(np.maximum(np.swapaxes(spec @ fb, -1, -2), 1e-10))


@pytest.mark.parametrize("kw", [{}, {"n_mels": 32, "input_length": 8192,
                                      "n_layers": 5}])
def test_log_mel_matches_jax_and_float64(kw):
    cfg, jcfg = CNNConfig(**kw), JaxCNNConfig(**kw)
    x = (np.random.default_rng(3).standard_normal((3, cfg.input_length))
         * 0.1).astype(np.float32)
    x[2, :300] = 0.0  # a silent stretch: bins at the 1e-10 clamp
    ours = mel.log_mel_spectrogram(torch.from_numpy(x), cfg).numpy()
    ref = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(x), jcfg))
    assert ours.shape == (3, cfg.n_mels, cfg.n_frames)
    np.testing.assert_allclose(ours, ref, **TOL)
    pw = mel.power_spectrogram(torch.from_numpy(x)).numpy()
    pw_ref = np.asarray(jax_mel.power_spectrogram(jnp.asarray(x)))
    np.testing.assert_allclose(pw, pw_ref, rtol=1e-5,
                               atol=1e-6 * pw_ref.max())
    exact = mel.log_mel_spectrogram(torch.from_numpy(x).double(), cfg)
    np.testing.assert_allclose(exact.numpy(), _oracle_log_mel(x, cfg),
                               rtol=0, atol=1e-4)


def test_amplitude_to_db_and_frame_count():
    p = torch.tensor([0.0, 1e-12, 1.0, 100.0])
    np.testing.assert_allclose(mel.amplitude_to_db(p).numpy(),
                               [-100.0, -100.0, 0.0, 20.0], atol=1e-6)
    assert CNNConfig().n_frames == jax_mel.n_frames_for(59049) == 231
