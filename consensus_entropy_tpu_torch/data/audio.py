"""Waveform storage and random-crop sampling.

Counterpart of ``consensus_entropy_tpu/data/audio.py``.  The pool's
waveforms sit zero-padded in one ``(n_songs, max_len)`` float32 tensor on
the device; a crop starts at ``floor(u * (len - L))`` with ``u`` from
``prng.uniform`` (the reference's ``short_cnn.py:376``), so crops equal
the JAX package's for the same key.  ``window_batch`` cuts the stride
grid of full-song scoring (``--full-song-hop``).  ``HostWaveformStore``
keeps the waveforms in host memory (optionally memory-mapped) for crop
and window scoring of pools larger than the device; it cannot train.
"""

from __future__ import annotations

import os
from typing import Mapping, Sequence

import numpy as np
import torch

from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.device import resolve_device


def crop_starts(u: torch.Tensor, lengths: torch.Tensor,
                input_length: int) -> torch.Tensor:
    """``floor(u * (len - L))`` in float32, as int64 (``u`` in [0, 1))."""
    return torch.floor(u * (lengths - input_length).to(torch.float32)).to(
        torch.int64)


class DeviceWaveformStore:
    """Every waveform on one device; crops sampled there.

    ``waveforms`` maps song id -> 1-D float array; ids get dense rows in
    insertion order (``row_of``).  ``device=None`` is the card."""

    def __init__(self, waveforms: Mapping[object, np.ndarray],
                 input_length: int, device=None):
        if not waveforms:
            raise ValueError("empty waveform store")
        ids = list(waveforms.keys())
        lengths = np.array([len(waveforms[s]) for s in ids], np.int64)
        buf = np.zeros((len(ids), int(lengths.max())), np.float32)
        for i, sid in enumerate(ids):
            w = np.asarray(waveforms[sid], np.float32)
            buf[i, : len(w)] = w
        dev = resolve_device(device)
        self._init(ids, torch.from_numpy(buf).to(dev),
                   torch.from_numpy(lengths).to(dev), input_length)

    @classmethod
    def from_padded(cls, ids: Sequence, data: torch.Tensor,
                    lengths: torch.Tensor,
                    input_length: int) -> "DeviceWaveformStore":
        """A store over an already padded ``(n, max_len)`` float32 tensor
        and its ``(n,)`` lengths, both on the store's device."""
        obj = cls.__new__(cls)
        obj._init(list(ids), data, lengths.to(torch.int64), input_length)
        return obj

    def _init(self, ids, data, lengths, input_length):
        self.input_length = int(input_length)
        self.ids = ids
        self._row = {sid: i for i, sid in enumerate(ids)}
        short = [s for s, n in zip(ids, lengths.tolist())
                 if n < self.input_length]
        if short:
            raise ValueError(
                f"{len(short)} waveform(s) shorter than input_length "
                f"{self.input_length}: {short[:5]}")
        self.data = data
        self.lengths = lengths

    @property
    def device(self) -> torch.device:
        return self.data.device

    def row_of(self, song_ids: Sequence) -> np.ndarray:
        return np.array([self._row[s] for s in song_ids], np.int64)

    def crops_at(self, rows: torch.Tensor,
                 starts: torch.Tensor) -> torch.Tensor:
        """``(len(rows), input_length)`` windows at ``starts``."""
        offs = torch.arange(self.input_length, device=self.device)
        flat = (rows * self.data.shape[1] + starts)[:, None] + offs
        return self.data.view(-1)[flat]

    def sample_crops(self, key: torch.Tensor, rows) -> torch.Tensor:
        """``(len(rows), input_length)`` random crops: one uniform draw per
        row from ``key``."""
        rows = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        u = prng.uniform(key, (rows.shape[0],), device=self.device)
        return self.crops_at(rows, crop_starts(u, self.lengths[rows],
                                               self.input_length))

    def n_windows(self, hop: int) -> int:
        """Windows of the stride grid at the store's longest song."""
        return (self.data.shape[1] - self.input_length) // int(hop) + 1

    def window_batch(self, rows, hop: int):
        """``(R, W, input_length)`` stride-``hop`` windows and an ``(R, W)``
        validity mask: a window is valid when it lies inside its song, so
        window 0 always is (the store holds no song shorter than
        ``input_length``)."""
        rows = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        windows = self.data[rows].unfold(1, self.input_length, int(hop))
        starts = torch.arange(self.n_windows(hop), device=self.device) * int(
            hop)
        valid = (starts[None, :] + self.input_length
                 <= self.lengths[rows][:, None])
        return windows, valid


def device_store_from_npy(npy_dir: str, song_ids: Sequence,
                          input_length: int,
                          device=None) -> DeviceWaveformStore:
    """``{song_id}.npy`` waveforms into a :class:`DeviceWaveformStore`
    (memory-mapped: the padded buffer is the only full host copy)."""
    waves = {sid: np.load(os.path.join(npy_dir, f"{sid}.npy"), mmap_mode="r")
             for sid in song_ids}
    return DeviceWaveformStore(waves, input_length, device)


class HostWaveformStore:
    """Crop and window scoring from host memory, for pools larger than the
    device: ``{song_id}.npy`` waveforms (memory-mapped with ``mmap``),
    each batch assembled in numpy and moved to ``device`` in one transfer
    (``device=None`` is the card).  It cannot train (the trainer crops on
    the device)."""

    def __init__(self, npy_dir: str, song_ids: Sequence, input_length: int,
                 mmap: bool = True, device=None):
        self.input_length = int(input_length)
        self.ids = list(song_ids)
        self._row = {sid: i for i, sid in enumerate(self.ids)}
        self._device = resolve_device(device)
        mode = "r" if mmap else None
        self._arrays = [np.load(os.path.join(npy_dir, f"{sid}.npy"),
                                mmap_mode=mode) for sid in self.ids]
        for sid, a in zip(self.ids, self._arrays):
            if len(a) < input_length:
                raise ValueError(f"waveform {sid} shorter than {input_length}")

    @property
    def device(self) -> torch.device:
        return self._device

    def row_of(self, song_ids: Sequence) -> np.ndarray:
        return np.array([self._row[s] for s in song_ids], np.int64)

    def sample_crops(self, key: torch.Tensor, rows) -> torch.Tensor:
        """``(len(rows), input_length)`` random crops: the device store's
        uniform draws, the start taken in numpy as the JAX host store
        takes it (``floor(float32 u * (len - L))``)."""
        rows = np.asarray(rows)
        u = prng.uniform(key, (len(rows),), device="cpu").numpy()
        out = np.empty((len(rows), self.input_length), np.float32)
        for j, (r, uj) in enumerate(zip(rows, u)):
            a = self._arrays[int(r)]
            start = int(np.floor(uj * (len(a) - self.input_length)))
            out[j] = a[start: start + self.input_length]
        return torch.from_numpy(out).to(self.device)

    def n_windows(self, hop: int) -> int:
        max_len = max(len(a) for a in self._arrays)
        return (max_len - self.input_length) // int(hop) + 1

    def window_batch(self, rows, hop: int):
        """The host-assembled ``DeviceWaveformStore.window_batch``: one
        transfer for the windows, one for the mask."""
        rows = np.asarray(rows)
        n_w = self.n_windows(hop)
        out = np.zeros((len(rows), n_w, self.input_length), np.float32)
        valid = np.zeros((len(rows), n_w), bool)
        for j, r in enumerate(rows):
            a = self._arrays[int(r)]
            for w in range(n_w):
                s = w * int(hop)
                if s + self.input_length <= len(a):
                    out[j, w] = a[s: s + self.input_length]
                    valid[j, w] = True
        return (torch.from_numpy(out).to(self.device),
                torch.from_numpy(valid).to(self.device))
