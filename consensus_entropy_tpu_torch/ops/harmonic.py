"""The learnable harmonic-filterbank frontend of the ``harm`` trunk.

Counterpart of ``consensus_entropy_tpu/ops/harmonic.py``: a power
spectrogram filtered by triangular bands centred on a MIDI-spaced
fundamental grid replicated at the harmonics 1..H, the band Q factor
``bw_q`` a trained parameter, then amplitude to dB.  The output is an
``(harmonic, level, time)`` image whose harmonics are the trunk's input
channels.

- The spectrogram is the mel frontend's two windowed-DFT matmuls
  (``ops.mel.power_spectrogram``).
- The filterbank depends on ``bw_q``, so it is built inside each forward
  (an outer-product chain over ``(n_freqs, n_bands)``) and gradients reach
  ``bw_q``.
- The note grid uses librosa's conversions in closed form
  (``note_to_midi('C1') == 24``; ``hz_to_note`` rounds to the nearest
  semitone), with no librosa.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from consensus_entropy_tpu_torch.ops.mel import (
    amplitude_to_db,
    power_spectrogram,
)

#: Glasberg-Moore ERB bandwidth coefficients (the reference's bw_alpha and
#: bw_beta)
BW_ALPHA = 0.1079
BW_BETA = 24.7

_C1_MIDI = 24  # librosa note_to_midi('C1')


def hz_to_midi(hz):
    return 12.0 * (np.log2(np.asarray(hz, np.float64)) - np.log2(440.0)) + 69


def midi_to_hz(midi):
    return 440.0 * 2.0 ** ((np.asarray(midi, np.float64) - 69.0) / 12.0)


@functools.lru_cache(maxsize=8)
def harmonic_center_freqs(sample_rate: int = 16000, n_harmonic: int = 6,
                          semitone_scale: int = 2):
    """``(center_hz, level)``: the fundamental grid spans C1 to the highest
    note whose ``n_harmonic``-th harmonic stays below Nyquist, at
    ``semitone_scale`` steps a semitone; the centres are that grid times
    each harmonic number, float32 (computed in float64)."""
    high_midi = int(np.round(hz_to_midi(sample_rate / (2.0 * n_harmonic))))
    level = (high_midi - _C1_MIDI) * semitone_scale
    midi = np.linspace(_C1_MIDI, high_midi, level + 1)
    hz = midi_to_hz(midi[:-1])
    centers = np.concatenate([hz * (i + 1) for i in range(n_harmonic)])
    return centers.astype(np.float32), level


@functools.lru_cache(maxsize=32)
def _on_device(sample_rate: int, n_fft: int, n_harmonic: int,
               semitone_scale: int, device: torch.device) -> tuple:
    """The centres ``(1, n_bands)`` and the bin frequencies ``(n_freqs,
    1)`` on ``device``, copied there once (a copy per forward would wait
    for the device's queue).  The bins are float32 ``stop * (i / (n -
    1))``, as ``jnp.linspace(0, sample_rate // 2, n)`` computes them."""
    f0, _ = harmonic_center_freqs(sample_rate, n_harmonic, semitone_scale)
    n = n_fft // 2 + 1
    step = np.arange(n, dtype=np.float32) / np.float32(n - 1)
    bins = (np.float32(sample_rate // 2) * step)[:, None]
    return (torch.from_numpy(f0[None, :]).to(device),
            torch.from_numpy(bins).to(device))


def harmonic_filterbank(bw_q: torch.Tensor, *, sample_rate: int = 16000,
                        n_fft: int = 512, n_harmonic: int = 6,
                        semitone_scale: int = 2) -> torch.Tensor:
    """The triangular band filterbank ``(n_freqs, n_harmonic * level)`` as
    a function of the ``(1,)`` tensor ``bw_q``: bandwidth ``(BW_ALPHA * f0
    + BW_BETA) / bw_q``, each column ramping 0 -> 1 -> 0 across ``f0 +-
    bw / 2``."""
    f0, bins = _on_device(sample_rate, n_fft, n_harmonic, semitone_scale,
                          bw_q.device)
    bw = (BW_ALPHA * f0 + BW_BETA) / bw_q
    up = bins * (2.0 / bw) + 1.0 - 2.0 * f0 / bw
    down = bins * (-2.0 / bw) + 1.0 + 2.0 * f0 / bw
    return torch.clamp(torch.minimum(up, down), min=0.0)


def harmonic_spectrogram(x: torch.Tensor, bw_q: torch.Tensor, *,
                         sample_rate: int = 16000, n_fft: int = 512,
                         hop_length: int = 256, n_harmonic: int = 6,
                         semitone_scale: int = 2) -> torch.Tensor:
    """Waveforms ``(..., L)`` -> the dB harmonic image ``(..., n_harmonic,
    level, n_frames)``."""
    power = power_spectrogram(x, n_fft, hop_length)  # (..., n_freqs, T)
    fb = harmonic_filterbank(bw_q, sample_rate=sample_rate, n_fft=n_fft,
                             n_harmonic=n_harmonic,
                             semitone_scale=semitone_scale).to(power.dtype)
    spec = fb.transpose(0, 1) @ power
    _, level = harmonic_center_freqs(sample_rate, n_harmonic, semitone_scale)
    return amplitude_to_db(spec.reshape(*spec.shape[:-2], n_harmonic, level,
                                        spec.shape[-1]))
