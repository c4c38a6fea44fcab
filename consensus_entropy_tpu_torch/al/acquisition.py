"""Acquisition: from the scoring step back to song ids.

Counterpart of ``consensus_entropy_tpu/al/acquisition.py``: the index <->
song-id mapping, the hc table's "queried rows never repeat"
removal (``amg_test.py:455,484``), the mix block split and the shrinking
pool mask, with every device shape fixed across the AL iterations.  Mode
behaviour is the registered strategy's (``consensus_entropy_tpu_torch.
acquire``); the ``Acquirer`` holds the per-user state the strategies work
on.  With a pool-axis ``mesh`` the step runs through the sharded families
of ``parallel.pool_mesh`` over operands split across the mesh.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from consensus_entropy_tpu_torch import acquire, prng
from consensus_entropy_tpu_torch.config import NUM_CLASSES
from consensus_entropy_tpu_torch.device import resolve_device
from consensus_entropy_tpu_torch.ops import scoring
from consensus_entropy_tpu_torch.ops.entropy import shannon_entropy
from consensus_entropy_tpu_torch.utils import round_up


@dataclasses.dataclass
class DevicePoolState:
    """Per-user state that stays on the device across AL iterations.

    - ``hc`` / ``hc_ent``: the human-consensus table and its row entropies,
      put there once at construction (hc/mix modes only).
    - ``probs``: the persistent ``(M, n_pad, C)`` member-probs buffer each
      select writes the live columns of; revealed songs' columns keep stale
      values behind the pool mask.
    - ``pool_mask`` / ``hc_mask``: device twins of the acquirer's host
      masks, built from them on first use (``Acquirer.device_masks``) and
      then updated in place by each fused step.
    - ``n_revealed``: songs revealed so far.
    - ``h2d_bytes`` / ``h2d_ops``: host->device traffic since the last
      ``Acquirer.take_h2d``.

    On a mesh the pool-axis members (``hc``, ``hc_ent``, ``probs`` and the
    masks) are ``parallel.mesh.ShardedRows`` split over the pool axis.

    The host numpy masks stay authoritative: checkpoints and every rebuild
    read them, never the twins.
    """

    hc: torch.Tensor | None = None
    hc_ent: torch.Tensor | None = None
    probs: torch.Tensor | None = None
    pool_mask: torch.Tensor | None = None
    hc_mask: torch.Tensor | None = None
    n_revealed: int = 0
    h2d_bytes: int = 0
    h2d_ops: int = 0


class Acquirer:
    """Per-user acquisition state over a fixed padded pool.

    ``train_songs``: the user's train-split song ids (pool rows, in order).
    ``hc_rows``: the human-consensus frequency table aligned with them
    (``amg_test.py:376``), or ``None``.  ``pad_to`` pads every pool to one
    minimum width so the step's shapes are shared across users.
    ``fuse_step``: stage the ``*_fused`` steps over the device masks (one
    call: score -> top-k -> in-place mask update); ``False`` keeps the
    two-call path that uploads the host masks each select.  ``device``:
    where the step runs (``None`` is the card).  ``mesh``: a pool-axis
    ``parallel.mesh.Mesh``; the step then runs sharded across it (the pad
    width a multiple of the pool axis times the processes, so every shard
    of every process is as wide), on the mesh's first device where
    ``device`` would put it.
    """

    #: probs-staging width bucket (``staging_width``)
    STAGING_BUCKET = 256

    def __init__(self, train_songs, hc_rows: np.ndarray | None, *,
                 queries: int, mode: str, tie_break: str = "fast",
                 pad_multiple: int = 8, seed: int = 0, mesh=None,
                 pad_to: int | None = None, fuse_step: bool = True,
                 device=None):
        self._mesh = mesh
        if mesh is not None:
            from consensus_entropy_tpu_torch.parallel import multihost
            from consensus_entropy_tpu_torch.parallel.mesh import POOL_AXIS

            if POOL_AXIS not in mesh.shape:
                raise ValueError(f"the acquirer's mesh needs a "
                                 f"{POOL_AXIS!r} axis, got {mesh.shape}")
            pad_multiple = math.lcm(pad_multiple,
                                    multihost.pool_shards(mesh))
            self.torch_device = mesh.axis_devices(POOL_AXIS)[0]
        else:
            self.torch_device = resolve_device(device)
        self.mode = mode
        self.fuse_step = fuse_step
        self.strategy = acquire.get(mode)
        #: per-member reliability weights ((M,) float32, committee order)
        #: for weight-consuming modes (wmc); None = uniform
        self.member_weights: np.ndarray | None = None
        self.queries = queries
        self.songs = list(train_songs)
        self.n_valid = len(self.songs)
        self.n_pad = round_up(max(self.n_valid, queries), pad_multiple)
        if pad_to:
            self.n_pad = max(self.n_pad, round_up(pad_to, pad_multiple))
        self._song_row = {s: i for i, s in enumerate(self.songs)}

        self.pool_mask = np.zeros(self.n_pad, bool)
        self.pool_mask[: self.n_valid] = True
        self.hc_mask = self.pool_mask.copy()
        self.hc = np.zeros((self.n_pad, NUM_CLASSES), np.float32)
        if hc_rows is not None:
            self.hc[: self.n_valid] = np.asarray(hc_rows, np.float32)
        else:
            self.hc_mask[:] = False
        if mesh is None:
            self._fns = scoring.make_scoring_fns(k=queries,
                                                 tie_break=tie_break)
        else:
            from consensus_entropy_tpu_torch.parallel.pool_mesh import (
                make_sharded_step_fns,
            )

            self._fns = make_sharded_step_fns(mesh, k=queries,
                                              tie_break=tie_break)
        # rand's key stream stays on the host: a split hashes two counters
        # in ~170 integer ops, microseconds here and a launch each on the
        # card; only the pool-wide draw runs on the device
        self._rand_key = prng.key(seed, "cpu")
        self.device = DevicePoolState()
        # the hc table never changes (only its mask shrinks): on the device
        # once, with its row entropies (padding rows give 0, behind the mask)
        if self.strategy.uses_hc_table:
            self.device.hc = self._feed(self.hc)
        if self.strategy.uses_hc_entropy:
            hc = self.device.hc
            self.device.hc_ent = (shannon_entropy(hc) if mesh is None
                                  else hc.map(shannon_entropy))

    def _feed(self, arr: np.ndarray, axis: int = 0):
        """A copy of a host array on the acquirer's device; on a mesh,
        split on ``axis`` over the pool axis (each process feeding only
        its own rows, ``parallel.multihost.feed_pool_axis``)."""
        if self._mesh is None:
            return torch.tensor(arr, device=self.torch_device)
        from consensus_entropy_tpu_torch.parallel import multihost

        return multihost.feed_pool_axis(arr, self._mesh, axis)

    @property
    def remaining_songs(self) -> list:
        return [s for s, ok in zip(self.songs, self.pool_mask) if ok]

    def staging_width(self, n_live: int) -> int:
        """The probs-staging width for ``n_live`` remaining songs:
        ``min(n_pad, round_up(n_live, 256))``, to pass as the committee's
        ``pad_to`` so the producer's shapes change once per bucket, not
        every iteration."""
        return min(self.n_pad,
                   round_up(max(n_live, 1), self.STAGING_BUCKET))

    def pad_probs(self, member_probs) -> np.ndarray:
        """``(M, W >= n_live, C)`` host probs (columns ``[0, n_live)`` over
        ``remaining_songs``, any tail staging padding) -> the fixed
        ``(M, n_pad, C)`` table."""
        member_probs = np.asarray(member_probs)
        out = np.zeros((member_probs.shape[0], self.n_pad, NUM_CLASSES),
                       np.float32)
        live = np.flatnonzero(self.pool_mask)
        out[:, live] = member_probs[:, : len(live)]
        return out

    def _staged_probs(self, member_probs) -> torch.Tensor:
        """The ``(M, n_pad, C)`` scoring input of the probs modes.

        Host numpy probs on the two-call path: padded on the host and
        uploaded whole.  Otherwise (a tensor, or numpy on the fused path,
        uploaded at the staging width) the live columns are written into
        the persistent device buffer; the staging tail past the live count
        is never read, so no index points past ``n_pad``.
        """
        d = self.device
        if self._mesh is not None:
            if self.fuse_step and isinstance(member_probs, np.ndarray):
                return self._staged_probs_mesh(member_probs)
            if isinstance(member_probs, torch.Tensor):
                member_probs = member_probs.cpu().numpy()
            padded = self.pad_probs(member_probs)
            d.h2d_bytes += padded.nbytes
            d.h2d_ops += 1
            return self._feed(padded, 1)
        if isinstance(member_probs, np.ndarray):
            if not self.fuse_step:
                padded = self.pad_probs(member_probs)
                d.h2d_bytes += padded.nbytes
                d.h2d_ops += 1
                return torch.from_numpy(padded).to(self.torch_device)
            member_probs = torch.from_numpy(
                self._staging_upload(member_probs))
        m = member_probs.shape[0]
        if d.probs is None or d.probs.shape[0] != m:
            d.probs = torch.zeros((m, self.n_pad, NUM_CLASSES),
                                  dtype=torch.float32,
                                  device=self.torch_device)
        live = np.flatnonzero(self.pool_mask)
        if member_probs.shape[1] < len(live):
            raise ValueError(f"member_probs width {member_probs.shape[1]} < "
                             f"{len(live)} live songs")
        d.probs.index_copy_(
            1, torch.from_numpy(live).to(self.torch_device),
            member_probs[:, : len(live)].to(self.torch_device,
                                            torch.float32))
        return d.probs

    def _staging_upload(self, member_probs: np.ndarray) -> np.ndarray:
        """Host probs padded to the staging width (a fixed upload shape),
        counted as one upload."""
        member_probs = np.asarray(member_probs, np.float32)
        w = self.staging_width(member_probs.shape[1])
        if member_probs.shape[1] < w:
            member_probs = np.pad(
                member_probs,
                ((0, 0), (0, w - member_probs.shape[1]), (0, 0)))
        self.device.h2d_bytes += member_probs.nbytes
        self.device.h2d_ops += 1
        return member_probs

    def _staged_probs_mesh(self, member_probs: np.ndarray):
        """The fused mesh arm of :meth:`_staged_probs`: the live block,
        host-padded to the staging width, scattered into the persistent
        pool-sharded buffer in place (each shard of this process writes the
        rows it holds; the staging tail's out-of-range rows are
        dropped)."""
        from consensus_entropy_tpu_torch.parallel import pool_mesh

        d = self.device
        member_probs = self._staging_upload(member_probs)
        w, m = member_probs.shape[1], member_probs.shape[0]
        if d.probs is None or d.probs.shape[0] != m:
            d.probs = pool_mesh.sharded_probs_buffer(
                self._mesh, m, self.n_pad, NUM_CLASSES)
        live = np.flatnonzero(self.pool_mask)
        if w < len(live):
            raise ValueError(f"member_probs width {w} < {len(live)} live "
                             f"songs")
        if w > len(live):  # out-of-range slots are dropped
            live = np.concatenate(
                [live, np.full(w - len(live), self.n_pad, live.dtype)])
        return pool_mesh.sharded_scatter_rows(self._mesh)(
            d.probs, torch.from_numpy(live), torch.from_numpy(member_probs))

    def take_h2d(self) -> tuple:
        """Drain the ``(bytes, ops)`` uploaded since the last read."""
        out = (self.device.h2d_bytes, self.device.h2d_ops)
        self.device.h2d_bytes = self.device.h2d_ops = 0
        return out

    def device_masks(self) -> DevicePoolState:
        """The device twins of the pool/hc masks, built from the host masks
        on first use: an acquirer rebuilt by ``replay`` gets twins equal to
        those an uninterrupted run holds."""
        d = self.device
        if d.pool_mask is None:
            d.pool_mask = self._feed(self.pool_mask)
            d.h2d_bytes += self.pool_mask.nbytes
            d.h2d_ops += 1
            if self.strategy.uses_hc_table:
                d.hc_mask = self._feed(self.hc_mask)
                d.h2d_bytes += self.hc_mask.nbytes
                d.h2d_ops += 1
        return d

    def scoring_inputs(self, member_probs=None, *, rand_key=None):
        """Stage this iteration's scoring call: ``(fn_key, inputs)``, the
        fused step when ``fuse_step`` and the strategy has one."""
        if self.fuse_step:
            staged = self.strategy.fused_inputs(self, member_probs,
                                                rand_key=rand_key)
            if staged is not None:
                return staged
        return self.strategy.scoring_inputs(self, member_probs,
                                            rand_key=rand_key)

    def run_scoring(self, fn_key: str, inputs):
        return self._fns[fn_key](*inputs)

    def finish_select(self, res) -> list:
        """Map a scoring result to song ids (with the strategy's hc removal
        and mix dedup) and shrink the host pool mask (``amg_test.py:
        520-523``).  A fused result's masks are the device twins, already
        updated in place; the host masks get the same flips from the
        returned indices."""
        if isinstance(res, scoring.FusedStepResult):
            d = self.device
            d.pool_mask = res.pool_mask
            if res.hc_mask is not None:
                d.hc_mask = res.hc_mask
        q_songs = self.strategy.extract_queries(self, res)
        for s in q_songs:
            self.pool_mask[self._song_row[s]] = False
        self.device.n_revealed += len(q_songs)
        return q_songs

    def select(self, member_probs=None, *, rand_key=None) -> list:
        """Pick the next query batch; returns song ids (<= ``queries``).

        ``member_probs``: ``(M, n_live, C)`` over ``remaining_songs`` (or
        wider, with a staging tail), for the probs modes.  ``rand_key``: an
        explicit key for rand (else the acquirer's seeded stream).
        """
        fn_key, inputs = self.scoring_inputs(member_probs, rand_key=rand_key)
        return self.finish_select(self.run_scoring(fn_key, inputs))

    def replay(self, queried_batches) -> None:
        """Re-apply completed iterations' query batches to the host masks:
        each queried song leaves the pool, and its hc row in the hc-table
        modes (``amg_test.py:455,484,520-523``)."""
        for batch in queried_batches:
            for s in batch:
                self.pool_mask[self._song_row[s]] = False
                if self.strategy.uses_hc_table:
                    self.hc_mask[self._song_row[s]] = False

    def _ids(self, res) -> list:
        idx = scoring.selection_scalars(res.indices)
        valid = scoring.selection_scalars(res.values) > -np.inf
        return [self.songs[int(i)] for i, ok in zip(idx, valid) if ok]

    def _remove_hc(self, q_songs):
        for s in q_songs:
            self.hc_mask[self._song_row[s]] = False
