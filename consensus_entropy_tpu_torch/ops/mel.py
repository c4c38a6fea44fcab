"""The CNN members' log-mel frontend, with torchaudio's semantics.

Counterpart of ``consensus_entropy_tpu/ops/mel.py:38-157``: the
reference's ``MelSpectrogram(sample_rate=16000, n_fft=512, f_min=0,
f_max=8000, n_mels=128)`` then ``AmplitudeToDB()`` (``short_cnn.py:
295-300``).

- STFT: ``win_length = n_fft``, ``hop = n_fft // 2``, centered with
  reflect padding, periodic Hann window, power 2, no normalization;
- mel filterbank: HTK scale, triangular filters, ``norm=None``, over the
  ``n_fft // 2 + 1`` linear bins (numpy, a constant of the config);
- ``10 * log10(max(x, 1e-10))``, no ``top_db``.

The DFT is two matmuls with the window folded into the cosine and sine
bases, as in the JAX package (not ``torch.stft``), so the sums take the
same form.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from consensus_entropy_tpu_torch.config import CNNConfig


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int = 16000, n_fft: int = 512,
                   n_mels: int = 128, f_min: float = 0.0,
                   f_max: float = 8000.0) -> np.ndarray:
    """Triangular HTK-mel filterbank ``(n_fft // 2 + 1, n_mels)`` float32
    (``torchaudio.functional.melscale_fbanks(..., norm=None,
    mel_scale='htk')``)."""
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max),
                        n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases ``(cos, -sin)``, ``(n_fft, n_freqs)``
    float32, the periodic Hann window folded in."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_freqs, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
    angle = 2.0 * np.pi * np.outer(n, k) / n_fft
    return ((np.cos(angle) * window[:, None]).astype(np.float32),
            (-np.sin(angle) * window[:, None]).astype(np.float32))


@functools.lru_cache(maxsize=32)
def _on_device(what: str, args: tuple, device: torch.device,
               dtype: torch.dtype) -> tuple:
    """The DFT bases or the filterbank as tensors on ``device``, copied
    there once: a copy per forward would wait for the device's queue."""
    arrays = (_dft_bases(*args) if what == "dft" else
              (mel_filterbank(*args),))
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype)
                 for a in arrays)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int):
    """Centered overlapping frames ``(..., n_frames, n_fft)`` and their
    count.  Requires ``hop == n_fft // 2``: after reflect padding by
    ``n_fft // 2`` a frame is two adjacent hop-sized chunks."""
    if hop * 2 != n_fft:
        raise ValueError("frame_signal requires hop == n_fft // 2")
    pad = n_fft // 2
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad),
               mode="reflect").reshape(*lead, -1)
    n_chunks = xp.shape[-1] // hop
    chunks = xp[..., : n_chunks * hop].reshape(*lead, n_chunks, hop)
    return (torch.cat([chunks[..., :-1, :], chunks[..., 1:, :]], dim=-1),
            n_chunks - 1)


def power_spectrogram(x: torch.Tensor, n_fft: int = 512,
                      hop: int = 256) -> torch.Tensor:
    """``|STFT|^2`` ``(..., n_freqs, n_frames)`` by the two windowed-DFT
    matmuls."""
    frames, _ = frame_signal(x, n_fft, hop)
    cos_b, sin_b = _on_device("dft", (n_fft,), x.device, x.dtype)
    re = frames @ cos_b
    im = frames @ sin_b
    return (re * re + im * im).transpose(-1, -2)


def amplitude_to_db(power: torch.Tensor, amin: float = 1e-10):
    """``AmplitudeToDB`` of a power: ``10 * log10(max(x, amin))``."""
    return 10.0 * torch.log10(torch.clamp(power, min=amin))


def log_mel_spectrogram(x: torch.Tensor,
                        config: CNNConfig = CNNConfig()) -> torch.Tensor:
    """Waveform ``(..., L)`` -> log-mel ``(..., n_mels, n_frames)``."""
    power = power_spectrogram(x, config.n_fft, config.hop_length)
    (fb,) = _on_device("mel", (config.sample_rate, config.n_fft,
                               config.n_mels, config.f_min, config.f_max),
                       x.device, power.dtype)
    return amplitude_to_db(fb.transpose(0, 1) @ power)
