"""Sequence parallelism: one long song's windows split across devices.

Counterpart of ``consensus_entropy_tpu/parallel/sequence.py``.  A song is
scored as the per-member mean of the CNN's sigmoid outputs over its
stride-``hop`` analysis windows (length = the crop, ``input_length``).
The window axis is split: each ``seq`` shard takes a contiguous chunk of
``windows_per_shard * hop`` samples.  Overlapping windows (``hop <
window``) need the first ``window - hop`` samples of the next chunk, the
halo: each shard copies it from its right neighbour's device (the JAX
package's one ``lax.ppermute``), and the last shard takes the song's
global tail.  Each shard's masked per-member sums (pad windows weigh 0)
add up on the first device.

A 10-minute 16 kHz song is about 9.6 M samples, 162 windows of 59,049.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from consensus_entropy_tpu_torch.config import CNNConfig
from consensus_entropy_tpu_torch.models import short_cnn
from consensus_entropy_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh


class WindowPlan(NamedTuple):
    """The geometry of a sharded full-song pass.

    n_windows:         valid windows (>= 1; pad windows past it are
                       masked out of the mean).
    windows_per_shard: windows each shard evaluates (pad included).
    chunk_len:         samples a shard holds in the base layout.
    halo:              samples a shard needs from its right neighbour.
    padded_len:        the padded song, ``n_shards * chunk_len + halo``.
    """

    n_windows: int
    windows_per_shard: int
    chunk_len: int
    halo: int
    padded_len: int
    window: int
    hop: int

    @property
    def n_shards(self) -> int:
        return (self.padded_len - self.halo) // self.chunk_len


def plan_windows(n_samples: int, n_shards: int, *, window: int,
                 hop: int | None = None) -> WindowPlan:
    """Window and shard geometry for a song of ``n_samples``.  Windows
    start at ``0, hop, 2*hop, ...`` and are valid when they lie inside the
    song (the reference's crop domain, ``short_cnn.py:376``); a song
    shorter than a window gets one zero-padded window."""
    if hop is None:
        hop = window
    if not 1 <= hop <= window:
        raise ValueError(f"need 1 <= hop ({hop}) <= window ({window})")
    n_valid = (n_samples - window) // hop + 1 if n_samples >= window else 1
    wps = math.ceil(n_valid / n_shards)
    halo = window - hop
    chunk_len = wps * hop
    if halo > chunk_len:
        # the halo comes from ONE right neighbour; a deeper overlap would
        # need several
        raise ValueError(
            f"window overlap ({halo} samples) exceeds the per-shard chunk "
            f"({chunk_len} = {wps} windows x hop {hop}); use fewer shards "
            f"for this song length or hop >= window - windows_per_shard*hop")
    return WindowPlan(n_valid, wps, chunk_len, halo,
                      n_shards * chunk_len + halo, window, hop)


def pad_song(wave, plan: WindowPlan) -> np.ndarray:
    """A ``(T,)`` waveform fitted to the plan's padded length: the tail
    zero-padded, or cut where the window grid ends before ``T``."""
    wave = np.asarray(wave, np.float32)
    if wave.ndim != 1:
        raise ValueError(f"expected (T,) waveform, got {wave.shape}")
    wave = wave[:plan.padded_len]
    return np.pad(wave, (0, plan.padded_len - wave.shape[0]))


def _local_windows(chunk_ext: torch.Tensor, plan: WindowPlan):
    """A shard's ``windows_per_shard`` windows of its extended chunk."""
    return torch.stack([chunk_ext[w * plan.hop: w * plan.hop + plan.window]
                        for w in range(plan.windows_per_shard)])


def make_full_song_scorer(mesh: Mesh, plan: WindowPlan,
                          config: CNNConfig = CNNConfig()):
    """The sequence-parallel full-song committee scorer:
    ``scorer(member_variables, padded_wave, n_windows=None) -> (M, C)``
    per-member mean sigmoid scores on the first ``seq`` device.
    ``member_variables``: one variables dict a member (copied once to each
    distinct device); ``padded_wave``: ``(padded_len,)`` from
    :func:`pad_song`."""
    if plan.window != config.input_length:
        raise ValueError(
            f"plan window {plan.window} != config.input_length "
            f"{config.input_length}")
    n_shards = mesh.shape[SEQ_AXIS]
    if plan.n_shards != n_shards:
        raise ValueError(f"plan built for {plan.n_shards} shards, mesh has "
                         f"{n_shards}")
    devices = mesh.axis_devices(SEQ_AXIS)
    body_len = n_shards * plan.chunk_len

    def scorer(member_variables, padded_wave, n_windows: int | None = None):
        n_windows = plan.n_windows if n_windows is None else int(n_windows)
        wave = torch.as_tensor(padded_wave, dtype=torch.float32)
        chunks = [wave[s * plan.chunk_len:(s + 1) * plan.chunk_len].to(dev)
                  for s, dev in enumerate(devices)]
        tail = wave[body_len:]
        variables = {}
        total = count = None
        with torch.no_grad():
            for s, dev in enumerate(devices):
                if dev not in variables:
                    variables[dev] = [{k: t.to(dev) for k, t in v.items()}
                                      for v in member_variables]
                chunk = chunks[s]
                if plan.halo:
                    # the halo: the head of the right neighbour's chunk,
                    # copied from its device; the last shard's is the tail
                    recv = (chunks[s + 1][:plan.halo] if s < n_shards - 1
                            else tail)
                    chunk = torch.cat([chunk, recv.to(dev)])
                probs = short_cnn.committee_infer(
                    variables[dev], _local_windows(chunk, plan), config)
                gid = s * plan.windows_per_shard + torch.arange(
                    plan.windows_per_shard, device=dev)
                weight = (gid < n_windows).to(probs.dtype)
                local = torch.einsum("mwc,w->mc", probs, weight).to(
                    devices[0])
                total = local if total is None else total + local
                n = weight.sum().to(devices[0])
                count = n if count is None else count + n
        return total / count

    return scorer


def full_song_probs_reference(member_variables, wave, plan: WindowPlan,
                              config: CNNConfig = CNNConfig(), device=None):
    """One device, no sharding: the same windows' per-member mean (the
    tests' oracle)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    padded = torch.as_tensor(pad_song(wave, plan), device=dev)
    windows = torch.stack([padded[w * plan.hop: w * plan.hop + plan.window]
                           for w in range(plan.n_windows)])
    with torch.no_grad():
        probs = short_cnn.committee_infer(
            [{k: t.to(dev) for k, t in v.items()} for v in member_variables],
            windows, config)
    return probs.mean(dim=1)
