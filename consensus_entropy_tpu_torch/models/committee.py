"""The pool in segment layout, the device-member committee, the CNN
member and the user's committee.

Counterpart of ``consensus_entropy_tpu/models/committee.py``:
``FramePool`` (``:50-121``), the closed-form device slice
(``DeviceMemberCommittee``; ``_device_member_probs`` ``:868-918``),
``CNNMember`` (``:126-206``) and ``Committee`` (``:365-1120, 1236-1325``),
quarantine and the depth dial (``depth_cap``), ``pool_probs`` over the
CNN block (one random crop a song, or with ``full_song_hop`` the masked
mean over the song's stride-window grid), the host members and, with
``device_members=True``, the device slice; the qbdc dropout committee; the
incremental host updates and the CNN retrain; the checkpoint snapshot; and
the cross-user device plans the fleet scheduler stacks (``:1168-1240,
1342-1554``: ``CNNScorePlan``, ``CNNEvalPlan``, ``QBDCScorePlan``,
``CNNRetrainPlan``, ``stage_device_plans`` / ``commit_device_plans`` /
``run_device_plans``).  With a pool-axis ``mesh`` the CNN forward's crop
(or window) rows are split across the mesh (``:228-290, 455-520``); with a
``train_mesh`` the retrain spreads the members over its member axis;
``predict_song_sequence`` scores one long song over a ``seq`` mesh
(``:1121-1166``).

The retrain and the host updates take an explicit ``tracer`` (the null
one by default) and the ``parent`` span their work runs under: the
trainer's ``retrain.fit`` spans, and one ``member.update`` span a host
member's update (``kind``, ``user``, the thread's CPU time).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
from typing import Sequence

import numpy as np
import torch

from consensus_entropy_tpu_torch import native, prng
from consensus_entropy_tpu_torch.config import (
    CNN_ARCHS,
    NUM_CLASSES,
    CNNConfig,
    TrainConfig,
)
from consensus_entropy_tpu_torch.device import resolve_device
from consensus_entropy_tpu_torch.models import short_cnn
from consensus_entropy_tpu_torch.models.base import (
    Member,
    _read_npz,
    _write_npz,
)
from consensus_entropy_tpu_torch.models.cnn_trainer import CNNTrainer
from consensus_entropy_tpu_torch.models.members import GNBMember, SGDMember
from consensus_entropy_tpu_torch.obs.trace import NULL_TRACER
from consensus_entropy_tpu_torch.ops.device_members import (
    MemberStacks,
    make_device_committee_scorer,
)
from consensus_entropy_tpu_torch.parallel import multihost
from consensus_entropy_tpu_torch.parallel.mesh import POOL_AXIS, ShardedRows
from consensus_entropy_tpu_torch.resilience import faults
from consensus_entropy_tpu_torch.utils import round_up


class FramePool:
    """Per-song frame features in segment layout.

    ``X``: ``(n_frames_total, F)`` rows grouped by song (stable sort of
    ``frame_song``); ``song_ids`` the unique songs in order; ``offsets``
    each song's first row.  ``mean_by_song(p)`` replaces the reference's
    ``DataFrame(...).groupby('s_id').mean()`` (``amg_test.py:437``).
    """

    def __init__(self, X: np.ndarray, frame_song: Sequence):
        frame_song = np.asarray(frame_song)
        order = np.argsort(frame_song, kind="stable")
        self.X = np.ascontiguousarray(np.asarray(X)[order])
        sorted_ids = frame_song[order]
        change = np.flatnonzero(
            np.r_[True, sorted_ids[1:] != sorted_ids[:-1]])
        self.offsets = change
        self.song_ids = list(sorted_ids[change])
        self.counts = np.diff(np.r_[change, len(sorted_ids)])
        self._starts = np.r_[change, len(sorted_ids)].astype(np.int64)
        self._index = {sid: i for i, sid in enumerate(self.song_ids)}
        #: per torch device: the scorer and the float32 frames on it, kept
        #: for the pool's lifetime (the pool never changes)
        self.device_cache: dict = {}

    @property
    def n_songs(self) -> int:
        return len(self.song_ids)

    def count_of(self, song) -> int:
        """Frames in ``song``'s segment."""
        return int(self.counts[self._index[song]])

    def row_of(self, songs: Sequence) -> np.ndarray:
        """Song rows (in ``song_ids`` order) of ``songs``."""
        return np.array([self._index[s] for s in songs], np.int64)

    def mean_by_song(self, frame_values: np.ndarray) -> np.ndarray:
        return self.mean_over_segments(frame_values, self._starts)

    def segment_view(self, songs: Sequence):
        """``(rows, starts)`` of a packed sub-table of ``songs``' frames, in
        ``songs`` order: ``rows`` index ``X``; ``starts`` are the n+1
        segment boundaries of the packed table."""
        idx = self.row_of(songs)
        counts = self.counts[idx].astype(np.int64)
        rows = (np.concatenate([np.arange(self.offsets[i],
                                          self.offsets[i] + self.counts[i])
                                for i in idx])
                if len(idx) else np.empty(0, np.int64))
        return rows, np.r_[0, np.cumsum(counts)].astype(np.int64)

    @staticmethod
    def mean_over_segments(frame_values: np.ndarray,
                           starts: np.ndarray) -> np.ndarray:
        """Per-segment mean over n+1 boundaries, summed in float64; an
        empty segment gives 0.  2-D float32 tables go through the host
        core (``native.segment_mean``), as the JAX package's do; other
        tables are reduced in numpy and returned in their float type
        (float32 at least)."""
        frame_values = np.asarray(frame_values)
        if frame_values.dtype == np.float32 and frame_values.ndim == 2:
            return native.segment_mean(frame_values, starts)
        starts = np.asarray(starts, np.int64)
        counts = np.diff(starts)
        full = counts > 0
        sums = np.zeros((len(counts),) + frame_values.shape[1:], np.float64)
        if full.any():
            # an empty segment has no rows between its neighbours' starts,
            # so the non-empty ones' starts bound the same rows
            sums[full] = np.add.reduceat(frame_values, starts[:-1][full],
                                         axis=0, dtype=np.float64)
        counts = np.maximum(counts, 1).reshape(
            (-1,) + (1,) * (frame_values.ndim - 1))
        return (sums / counts).astype(
            np.result_type(frame_values.dtype, np.float32))

    def rows_for_songs(self, songs: Sequence) -> np.ndarray:
        """Row indices of all frames of ``songs``, in pool order."""
        wanted = set(songs)
        keep = [np.arange(self.offsets[i], self.offsets[i] + self.counts[i])
                for i, sid in enumerate(self.song_ids) if sid in wanted]
        return np.concatenate(keep) if keep else np.empty(0, np.int64)


class DeviceMemberCommittee:
    """A committee of closed-form members (GaussianNB first, then
    SGD-logistic) scored on one device.

    ``stacks``: their parameters on that device
    (``convert.device_members_from_numpy``); assign new stacks after the
    members retrain.  Each pass scores the whole pool and keeps the live
    songs' columns, as the JAX device slice does (a fixed-shape pass).
    """

    def __init__(self, stacks: MemberStacks):
        self.stacks = MemberStacks(*stacks)

    @property
    def device(self) -> torch.device:
        return self.stacks.gnb_theta.device

    @property
    def n_members(self) -> int:
        return self.stacks.gnb_theta.shape[0] + self.stacks.sgd_coef.shape[0]

    def _cached(self, pool: FramePool):
        """The pool's scorer and float32 frames on this device, built once
        per pool (``committee.py:889-899``)."""
        cache = pool.device_cache.get(self.device)
        if cache is None:
            frame_song = np.repeat(np.arange(pool.n_songs), pool.counts)
            cache = (make_device_committee_scorer(frame_song, pool.n_songs,
                                                  self.device),
                     torch.from_numpy(np.asarray(pool.X, np.float32)).to(
                         self.device))
            pool.device_cache[self.device] = cache
        return cache

    def score_pool(self, pool: FramePool) -> torch.Tensor:
        """``(G+S, pool.n_songs, C)`` per-member per-song probabilities."""
        scorer, x = self._cached(pool)
        return scorer(x, *self.stacks)

    def pool_probs(self, pool: FramePool, song_ids: Sequence,
                   pad_to: int | None = None) -> torch.Tensor:
        """``(G+S, width, C)`` over ``song_ids`` (``width`` is ``pad_to`` or
        ``len(song_ids)``).  Columns past the live songs are staging
        padding: copies of the last live song's column, which the
        acquirer's scatter drops (``committee.py:651-658``)."""
        n_live = len(song_ids)
        if pad_to is not None and pad_to < n_live:
            raise ValueError(f"pad_to={pad_to} < n={n_live}")
        width = n_live if pad_to is None else pad_to
        if width > n_live == 0:
            raise ValueError("pad_to requires at least one live song")
        sel = pool.row_of(song_ids)
        if width > n_live:
            sel = np.concatenate([sel, np.repeat(sel[-1:], width - n_live)])
        return self.score_pool(pool).index_select(
            1, torch.from_numpy(sel).to(self.device))


class CNNMember(Member):
    """A ShortChunkCNN committee member: its variables are torch tensors
    on the committee's device (``models.short_cnn`` names).  Files are the
    port's ``.npz`` (CRC32 trailer) in float32 or bfloat16; loading casts
    to float32."""

    kind = "cnn"

    #: config fields that shape no parameter: a file carries them and
    #: loading honours them (``committee.py:163-164``)
    FRONTEND_META = ("arch", "n_harmonic", "semitone_scale", "n_mels",
                     "n_fft", "hop_length", "f_min", "f_max", "sample_rate")

    def __init__(self, name: str, variables: dict,
                 config: CNNConfig = CNNConfig(), stem: str | None = None):
        super().__init__(name)
        self.variables = variables
        self.config = config
        #: the kind its file is named by (``Committee.member_file``): the
        #: one it was loaded or converted under, else its trunk's
        self.stem = stem or self.file_stem(config.arch)

    @staticmethod
    def file_stem(arch: str) -> str:
        """The member-file kind of trunk family ``arch``: ``cnn`` for vgg,
        ``cnn_{arch}`` for the others, as the pre-trainer names its folds
        (``pretrain.py:175``)."""
        return "cnn" if arch == "vgg" else f"cnn_{arch}"

    @classmethod
    def stem_of(cls, fname: str) -> str | None:
        """The CNN stem ``fname`` (``classifier_{stem}.{name}.*``) is
        named by, ``None`` when it names no CNN member."""
        base = os.path.basename(fname)
        if not base.startswith("classifier_"):
            return None
        stem = base[len("classifier_"):].split(".")[0]
        return stem if stem in _CNN_STEMS else None

    @property
    def variables(self) -> dict:
        return self._variables

    @variables.setter
    def variables(self, value):
        """Rebinding marks the member dirty: ``begin_save`` writes only
        members whose variables changed since their last file
        (``ckpt_clean_path`` names that file).  Retraining rebinds, never
        changes a tensor in place."""
        self._variables = value
        self.ckpt_dirty = True
        self.ckpt_clean_path: str | None = None

    def predict_proba(self, X):
        raise TypeError("CNNMember scores audio crops via Committee")

    def update(self, X, y):
        raise TypeError("CNNMember retrains via Committee.retrain_cnns")

    def save(self, path: str, variables: dict | None = None,
             dtype: str | None = None, meta: dict | None = None) -> None:
        """Write ``variables`` (default the member's own) as float32, or
        as bfloat16 bits (``dtype="bfloat16"``); ``meta`` adds fields to
        the header (the pre-trainer's resume fingerprint)."""
        variables = self.variables if variables is None else variables
        dtype = dtype or "float32"
        if dtype == "bfloat16":
            arrays = {k: t.detach().to(torch.bfloat16).view(torch.int16)
                      .cpu().numpy() for k, t in variables.items()}
        elif dtype == "float32":
            arrays = {k: t.detach().to(torch.float32).cpu().numpy()
                      for k, t in variables.items()}
        else:
            raise ValueError(f"unsupported checkpoint dtype {dtype!r}")
        header = {**(meta or {}), "kind": self.kind, "name": self.name,
                  "dtype": dtype,
                  **{k: getattr(self.config, k) for k in self.FRONTEND_META}}
        _write_npz(path, header, arrays)

    @classmethod
    def load(cls, path: str, config: CNNConfig = CNNConfig(),
             device=None) -> "CNNMember":
        meta, a = _read_npz(path)
        override = {k: meta[k] for k in cls.FRONTEND_META
                    if k in meta and meta[k] != getattr(config, k)}
        if override:
            config = dataclasses.replace(config, **override)
        dev = resolve_device(device)
        if meta["dtype"] == "bfloat16":
            variables = {k: torch.from_numpy(v).view(torch.bfloat16).to(
                torch.float32) for k, v in a.items()}
        else:
            variables = {k: torch.from_numpy(v) for k, v in a.items()}
        member = cls(meta["name"], {k: v.to(dev) for k, v in
                                    variables.items()}, config,
                     cls.stem_of(path))
        # loaded == the file's content: the member is clean against it
        member.ckpt_dirty = False
        member.ckpt_clean_path = os.path.abspath(path)
        return member


_CNN_STEMS = frozenset(CNNMember.file_stem(a) for a in CNN_ARCHS)


def _keep_columns(out: torch.Tensor, keep: int) -> torch.Tensor:
    """A bucket-wide ``(M, W, C)`` block cut to ``keep`` columns, extended
    with repeats of the last column if ``keep`` exceeds it."""
    if keep > out.shape[1]:
        out = torch.cat([out, out[:, -1:].expand(
            -1, keep - out.shape[1], -1)], dim=1)
    return out[:, :keep]


class CommitteeExhaustedError(RuntimeError):
    """Quarantine left fewer members than ``Committee.min_members``."""


class Committee:
    """The user's private committee: host members (GaussianNB, SGD-
    logistic, boosted trees) and CNN members.

    ``device_members=True`` scores the GaussianNB and SGD-logistic members
    on ``device`` through a :class:`DeviceMemberCommittee` whose stacks are
    rebuilt from the members' parameters at each pass; the boosted trees
    stay on the host (``committee.py:841-866``) and training stays on the
    host either way.  CNN members score and retrain on ``device`` (their
    variables are moved there); ``device=None`` is the card.

    ``full_song_hop``: CNN members score each song as the masked mean over
    its stride-``full_song_hop`` windows (deterministic, covering the
    whole song) instead of one random crop a pass; qbdc keeps its crops.

    ``mesh``: a pool-axis ``parallel.mesh.Mesh``.  The CNN forward then
    splits each crop (or window) batch's rows across it, each shard on its
    device with the member weights copied once per distinct device, and
    gathers the scores to the committee's device; the batches are padded
    to a shard-divisible width, so the crop stream and the scores are the
    unmeshed path's.  ``train_mesh``: a ``(dp, member)`` mesh
    (``make_training_mesh``) whose member axis the retrain spreads the
    members over (``CNNTrainer.fit_many``).  A meshed committee stages no
    fleet plan: its placements do not stack across users.
    """

    #: the crop compile bucket of the JAX package (``Acquirer.
    #: STAGING_BUCKET``): crops are sampled for a pool padded to a multiple
    #: of it, so a song's crop does not depend on the pool's width, and
    #: forwarded in bucket-wide slices
    CROP_BUCKET = 256
    #: songs a window-grid forward takes, bounding the ``(chunk, W, L)``
    #: windows (on a mesh, rounded up to the pool shards)
    WINDOW_CHUNK = 8

    def __init__(self, host_members: list[Member], cnn_members=(),
                 config: CNNConfig = CNNConfig(),
                 train_config: TrainConfig = TrainConfig(), *,
                 device_members: bool = False, min_members: int = 1,
                 full_song_hop: int | None = None, device=None, mesh=None,
                 train_mesh=None):
        self.host_members = list(host_members)
        self.cnn_members = list(cnn_members)
        self.device_members = device_members
        #: where the device slice and the CNN members run
        self.device = (resolve_device(device)
                       if device_members or self.cnn_members else None)
        if self.cnn_members:
            # one architecture for every CNN member; the committee's config
            # follows the members' (their files know theirs)
            keys = CNNMember.FRONTEND_META
            sigs = {tuple(getattr(m.config, k) for k in keys)
                    for m in self.cnn_members}
            if len(sigs) > 1:
                raise ValueError(
                    f"CNN members mix trunk families/frontend geometries "
                    f"{sorted(sigs)}; a committee needs one architecture")
            sig = sigs.pop()
            if sig != tuple(getattr(config, k) for k in keys):
                config = dataclasses.replace(config, **dict(zip(keys, sig)))
            for m in self.cnn_members:
                if any(t.device != self.device
                       for t in m.variables.values()):
                    # a move changes no value: keep the member's clean state
                    dirty, clean = m.ckpt_dirty, m.ckpt_clean_path
                    m.variables = {k: t.to(self.device)
                                   for k, t in m.variables.items()}
                    m.ckpt_dirty, m.ckpt_clean_path = dirty, clean
        self.config = config
        if full_song_hop is not None and not (
                1 <= full_song_hop <= config.input_length):
            raise ValueError(
                f"full_song_hop must be in [1, input_length="
                f"{config.input_length}], got {full_song_hop}")
        self.full_song_hop = full_song_hop
        self.trainer = CNNTrainer(config, train_config)
        #: quarantine: a member whose update or predict raises, or whose
        #: probabilities go non-finite, leaves the run; the run aborts only
        #: below ``min_members`` survivors
        self.min_members = min_members
        self.quarantined: dict[str, str] = {}
        self._pending_events: list[dict] = []
        #: the depth dial (``FleetScheduler.set_depth``): ``None`` is the
        #: full committee; an int caps how many active members score, CNN
        #: members keeping their seats first, floored at ``min_members``.
        #: Volatile: nothing checkpointed reads it
        self.depth_cap: int | None = None
        self.mesh = mesh
        self.train_mesh = train_mesh
        #: the global pool axis (every process's shards): crop buckets and
        #: window chunks are multiples of it
        self._n_pool_shards = (1 if mesh is None
                               else multihost.pool_shards(mesh))
        #: sequence-parallel scorers by (geometry, mesh); they take the
        #: member variables as an argument, so a retrain needs no flush
        self._seq_scorers: dict = {}

    # -- mesh feeds --------------------------------------------------------

    def _feed_repl(self, member_variables: list) -> dict:
        """The member variables on every distinct device of the pool axis
        (one copy a device), keyed by device."""
        out = {}
        for dev in self.mesh.axis_devices(POOL_AXIS):
            if dev not in out:
                out[dev] = [{k: t.to(dev) for k, t in v.items()}
                            for v in member_variables]
        return out

    def _feed_rows(self, x: torch.Tensor) -> ShardedRows:
        """A row batch split over the pool axis (each process feeding its
        own rows)."""
        return multihost.feed_pool_axis(x, self.mesh, 0)

    @staticmethod
    def _gather_rows(out: ShardedRows) -> torch.Tensor:
        """The forward's sharded ``(M, rows, C)`` back whole on the first
        device (from every process)."""
        return multihost.gather_ranks(out.full(), out.axis)

    def _forward(self, fn, variables: list, replicas: dict | None,
                 *xs) -> torch.Tensor:
        """``fn(member_variables, *xs) -> (M, rows, C)``: whole, or with
        ``replicas`` (:meth:`_feed_repl`) on each pool shard's rows with
        its device's copy of the variables, the results gathered."""
        if replicas is None:
            return fn(variables, *xs)
        fed = [self._feed_rows(x) for x in xs]
        lead = fed[0]
        outs = [fn(replicas[b.device], *(f.blocks[s] for f in fed))
                for s, b in enumerate(lead.blocks)]
        return self._gather_rows(ShardedRows(outs, 1, lead.offsets, lead.n))

    @property
    def member_names(self) -> list[str]:
        """Committee order: CNN members first (``committee.py:519-524``)."""
        return ([m.name for m in self.cnn_members]
                + [m.name for m in self.host_members])

    # -- quarantine --------------------------------------------------------

    def _active_pair(self) -> tuple[list, list]:
        """``(cnn, host)`` members still in the run, with the depth dial
        applied: CNN members first, host members fill what the cap
        leaves."""
        cnn = [m for m in self.cnn_members if m.name not in self.quarantined]
        host = [m for m in self.host_members
                if m.name not in self.quarantined]
        if self.depth_cap is None:
            return cnn, host
        cap = max(int(self.depth_cap), int(self.min_members), 1)
        if len(cnn) + len(host) <= cap:
            return cnn, host
        kept = cnn[:cap]
        return kept, host[:cap - len(kept)]

    @property
    def active_host_members(self) -> list[Member]:
        return self._active_pair()[1]

    @property
    def active_cnn_members(self) -> list[CNNMember]:
        return self._active_pair()[0]

    @property
    def active_size(self) -> int:
        cnn, host = self._active_pair()
        return len(cnn) + len(host)

    def quarantine(self, name: str, reason: str) -> None:
        """Remove ``name`` from the run (idempotent); raises
        :class:`CommitteeExhaustedError` below ``min_members``."""
        if name in self.quarantined:
            return
        self.quarantined[name] = reason
        self._pending_events.append({"member": name, "reason": reason})
        if self.active_size < self.min_members:
            raise CommitteeExhaustedError(
                f"{self.active_size} committee member(s) survive after "
                f"quarantining {name!r} ({reason}); floor is "
                f"min_members={self.min_members}")

    def drain_quarantine_events(self) -> list[dict]:
        events, self._pending_events = self._pending_events, []
        return events

    # -- scoring -----------------------------------------------------------

    def pool_probs(self, pool: FramePool, song_ids: Sequence,
                   pad_to: int | None = None, *, store=None, key=None,
                   cnn_block=None):
        """Stacked member probabilities ``(M, N, C)`` over ``song_ids`` in
        committee order (CNN members first), ``(M, pad_to, C)`` with a
        staging tail the acquirer drops.  The CNN block scores one random
        crop a song from ``store`` under ``key`` (:meth:`predict_songs_cnn`),
        or is ``cnn_block``, produced already (a stacked plan dispatch).
        A committee with CNN members or a device slice returns a tensor on
        its device; a host-only one returns numpy."""
        n_live = len(song_ids)
        if pad_to is not None and pad_to < n_live:
            raise ValueError(f"pad_to={pad_to} < n={n_live}")
        active_cnn, active = self._active_pair()
        if pad_to is not None and n_live == 0 and active:
            raise ValueError("pad_to requires at least one live song")
        if active_cnn and cnn_block is None:
            if store is None or key is None:
                raise ValueError("CNN members score audio: pass the "
                                 "waveform store and the pass's key")
            # queued first: the host members below compute meanwhile
            cnn_block = self.predict_songs_cnn(store, song_ids, key,
                                               pad_to=pad_to)
        return self.merge_blocks(cnn_block,
                                 self.host_block(pool, song_ids, pad_to))

    def host_block(self, pool: FramePool, song_ids: Sequence,
                   pad_to: int | None = None):
        """The host members' part of :meth:`pool_probs`, or ``None`` when
        no host member is active.  Without a device slice it is numpy and
        touches no tensor, so the fleet runs it on a host worker."""
        if not self.active_host_members:
            return None
        return self._host_probs(pool, song_ids, pad_to)

    @staticmethod
    def merge_blocks(cnn_block, host_block):
        """``(M_cnn + M_host, W, C)``: the CNN block then the host block,
        on the CNN block's device (either may be ``None``)."""
        if host_block is None:
            return cnn_block
        if cnn_block is None:
            return host_block
        return torch.cat([cnn_block, torch.as_tensor(host_block).to(
            cnn_block.device)], dim=0)

    def _host_probs(self, pool: FramePool, song_ids: Sequence,
                    pad_to: int | None):
        """The host members' block: the device slice's tensor merged with
        the host-scored members, or numpy without a device slice."""
        n_live = len(song_ids)
        active = self.active_host_members
        width = n_live if pad_to is None else pad_to
        sel = pool.row_of(song_ids)
        if width > n_live:
            sel = np.concatenate([sel, np.repeat(sel[-1:], width - n_live)])
        on_device, on_host = self._split_members()
        dev_block = None
        if on_device["gnb"] or on_device["sgd"]:
            # the device slice first: its launches queue while the host
            # members below compute
            dev_block = self._device_member_probs(pool, on_device)
            dev_block = dev_block.index_select(
                1, torch.from_numpy(sel).to(dev_block.device))
        host_np = np.empty((len(on_host), width, NUM_CLASSES), np.float32)
        if on_host:
            # host members score only the live songs' frames
            live_rows, seg_starts = pool.segment_view(song_ids)
            X_live = pool.X[live_rows]
            for slot, (_, m) in enumerate(on_host):
                mname = m.name
                row = None
                try:
                    frame_p = faults.fire(
                        "member.predict",
                        payload=m.predict_proba(X_live), member=mname)
                    row = pool.mean_over_segments(frame_p, seg_starts)
                except Exception as e:
                    self.quarantine(mname, f"predict failed: {e!r}")
                if row is not None and not np.all(np.isfinite(row)):
                    self.quarantine(mname, "non-finite probability rows")
                    row = None
                if row is None:
                    # NaN'd: the acquirer's sanitizer renormalizes this
                    # pass over the survivors
                    host_np[slot] = np.nan
                else:
                    host_np[slot, :n_live] = row
            host_np[:, n_live:] = host_np[:, n_live - 1: n_live]
        if dev_block is None:
            return host_np
        # merge the device slice and the host block back into committee
        # order with one permutation gather on the device
        combined = torch.cat([dev_block, torch.from_numpy(host_np).to(
            dev_block.device)], dim=0)
        order = np.empty(len(active), np.int64)
        for slot, (i, _) in enumerate(on_device["gnb"] + on_device["sgd"]):
            order[i] = slot
        n_dev = len(on_device["gnb"]) + len(on_device["sgd"])
        for slot, (i, _) in enumerate(on_host):
            order[i] = n_dev + slot
        return combined.index_select(
            0, torch.from_numpy(order).to(combined.device))

    def _split_members(self):
        """Partition the active members into the device-representable
        GaussianNB / SGD slices (fitted on the full class universe) and
        the host remainder."""
        out = {"gnb": [], "sgd": []}
        active = self.active_host_members
        if not self.device_members:
            return out, list(enumerate(active))
        rest = []
        for i, m in enumerate(active):
            full = np.array_equal(getattr(m, "classes_", None),
                                  np.arange(NUM_CLASSES))
            if full and isinstance(m, GNBMember):
                out["gnb"].append((i, m))
            elif (full and isinstance(m, SGDMember)
                  and m.coef_.shape[0] == NUM_CLASSES):
                out["sgd"].append((i, m))
            else:
                rest.append((i, m))
        return out, rest

    def _device_member_probs(self, pool: FramePool,
                             on_device) -> torch.Tensor:
        """``(G+S, n_songs, C)`` per-song means of the device slice over
        the whole pool (a fixed-shape pass; live columns are picked
        after), from stacks built from the members' current parameters."""
        from consensus_entropy_tpu_torch.convert import (
            device_members_from_numpy,
        )

        n_feat = pool.X.shape[1]
        gnb = [m for _, m in on_device["gnb"]]
        sgd = [m for _, m in on_device["sgd"]]

        def stack(arrays, shape):
            return np.stack(arrays) if arrays else np.zeros(shape)

        stacks = device_members_from_numpy(
            stack([m.theta_ for m in gnb], (0, NUM_CLASSES, n_feat)),
            stack([m.var_ for m in gnb], (0, NUM_CLASSES, n_feat)),
            stack([np.log(m.class_prior_) for m in gnb], (0, NUM_CLASSES)),
            stack([m.coef_ for m in sgd], (0, NUM_CLASSES, n_feat)),
            stack([m.intercept_ for m in sgd], (0, NUM_CLASSES)),
            self.device)
        return DeviceMemberCommittee(stacks).score_pool(pool)

    # -- CNN members -------------------------------------------------------

    @property
    def _crop_bucket(self) -> int:
        """``CROP_BUCKET``, made divisible by the pool shards."""
        return math.lcm(self.CROP_BUCKET, self._n_pool_shards)

    def _bucketed_crops(self, store, rows, key) -> torch.Tensor:
        """Crops of ``rows`` padded (repeating the last row) to a multiple
        of the crop bucket, sampled at the full width: threefry draws are
        prefix-stable in the width, so the real rows' crops do not depend
        on the padding."""
        pad = -len(rows) % self._crop_bucket
        rows_in = (np.concatenate([rows, np.repeat(rows[-1:], pad)])
                   if pad else rows)
        return store.sample_crops(key, rows_in)

    def predict_songs_cnn(self, store, song_ids, key, *,
                          pad_to: int | None = None) -> torch.Tensor:
        """``(M_cnn, n, C)`` CNN scores, or ``(M_cnn, pad_to, C)`` whose
        tail columns are padding (``committee.py:1022-1119``).  By default
        one random crop a song under ``key``: the forward runs in
        ``CROP_BUCKET``-wide slices, one member after another, and the
        tail holds the bucket padding's extra crops.  With
        ``full_song_hop``: the masked mean over each song's window grid,
        ``WINDOW_CHUNK`` songs a forward, the tail repeating the last
        song's column.  On a mesh each bucket (or window chunk) splits its
        rows over the pool shards."""
        rows = store.row_of(song_ids)
        if pad_to is not None and pad_to < len(rows):
            raise ValueError(f"pad_to={pad_to} < n={len(rows)}")
        active = self.active_cnn_members
        if len(rows) == 0:
            return torch.zeros((len(active), pad_to or 0,
                                self.config.n_class), device=self.device)
        variables = [m.variables for m in active]
        replicas = None if self.mesh is None else self._feed_repl(variables)
        with torch.no_grad():
            if self.full_song_hop is None:
                crops = self._bucketed_crops(store, rows, key)
                bucket = self._crop_bucket
                out = torch.cat([self._forward(
                    self._crop_probs, variables, replicas,
                    crops[lo: lo + bucket])
                    for lo in range(0, crops.shape[0], bucket)], dim=1)
            else:
                chunk = self._window_chunk
                out = torch.cat([self._windows_forward(
                    variables, replicas, store, rows[lo: lo + chunk])
                    for lo in range(0, len(rows), chunk)], dim=1)
        return _keep_columns(out, len(rows) if pad_to is None else pad_to)

    def _crop_probs(self, variables, crops) -> torch.Tensor:
        return short_cnn.committee_infer(variables, crops, self.config)

    @property
    def _window_chunk(self) -> int:
        """``WINDOW_CHUNK``, made divisible by the pool shards."""
        return round_up(self.WINDOW_CHUNK, self._n_pool_shards)

    def _windows_forward(self, variables, replicas, store,
                         rows) -> torch.Tensor:
        """``(M, len(rows), C)``: each member's scores of ``rows``' windows
        averaged over the valid ones (``committee.py:260-268``), the chunk
        padded to :attr:`_window_chunk` songs by repeating its last song
        and cut back; on a mesh the chunk's songs split over the pool
        shards."""
        n = len(rows)
        pad = self._window_chunk - n
        if pad:
            rows = np.concatenate([rows, np.repeat(rows[-1:], pad)])
        windows, valid = store.window_batch(rows, self.full_song_hop)
        return self._forward(self._window_mean, variables, replicas,
                             windows, valid)[:, :n]

    def _window_mean(self, variables, windows, valid) -> torch.Tensor:
        """``(R, W, L)`` windows and their ``(R, W)`` mask -> ``(M, R, C)``
        masked window means."""
        r, w, length = windows.shape
        probs = short_cnn.committee_infer(
            variables, windows.reshape(r * w, length), self.config)
        probs = probs.reshape(probs.shape[0], r, w, probs.shape[-1])
        weight = valid.to(probs.dtype)
        return ((probs * weight[None, :, :, None]).sum(dim=2)
                / weight.sum(dim=1)[None, :, None])

    def predict_song_sequence(self, wave, seq_mesh, *,
                              hop: int | None = None) -> torch.Tensor:
        """Sequence-parallel full-song CNN scores ``(M_cnn, C)`` of one
        long waveform (``parallel.sequence``): its windows split over
        ``seq_mesh``'s ``seq`` axis with the halo copied between
        neighbours, so the audio is not replicated per device.  ``hop``
        defaults to ``full_song_hop`` (else the window: no overlap).
        Scorers are cached by padded geometry and mesh; for pools of short
        excerpts use :meth:`predict_songs_cnn`."""
        from consensus_entropy_tpu_torch.parallel.mesh import SEQ_AXIS
        from consensus_entropy_tpu_torch.parallel.sequence import (
            make_full_song_scorer,
            pad_song,
            plan_windows,
        )

        if not self.active_cnn_members:
            raise ValueError("committee has no CNN members to score with")
        wave = np.asarray(wave, np.float32)
        plan = plan_windows(wave.shape[0], seq_mesh.shape[SEQ_AXIS],
                            window=self.config.input_length,
                            hop=self.full_song_hop if hop is None else hop)
        key = (plan.windows_per_shard, plan.chunk_len, plan.halo,
               plan.window, plan.hop, seq_mesh)
        scorer = self._seq_scorers.get(key)
        if scorer is None:
            scorer = self._seq_scorers[key] = make_full_song_scorer(
                seq_mesh, plan, self.config)
        return scorer([m.variables for m in self.active_cnn_members],
                      torch.from_numpy(pad_song(wave, plan)), plan.n_windows)

    def _qbdc_stage(self, store, rows, key, k: int):
        """Split the pass's key into the crop and the mask streams, fire
        ``acquire.qbdc.masks``, draw the bucket-padded crops: ``(crops,
        mask_keys)``."""
        crop_key, mask_key = prng.split(key)
        faults.fire("acquire.qbdc.masks", k=int(k))
        return (self._bucketed_crops(store, rows, crop_key),
                prng.split(mask_key, k))

    def qbdc_pool_probs(self, store, song_ids, key, *, k: int,
                        pad_to: int | None = None) -> torch.Tensor:
        """Query-by-dropout-committee probabilities ``(K, N, C)`` (or
        ``(K, pad_to, C)``): the first active CNN member under ``k`` seeded
        unit-level dropout masks (``committee.py:727-806``)."""
        active = self.active_cnn_members
        if not active:
            raise ValueError(
                "qbdc acquisition needs a committee with at least one "
                "(active) CNN member: the dropout committee is K masked "
                "forwards of that network")
        if k < 1:
            raise ValueError(f"qbdc committee width must be >= 1, got {k}")
        if store is None:
            raise ValueError("qbdc scoring needs the waveform store")
        rows = store.row_of(song_ids)
        if pad_to is not None and pad_to < len(rows):
            raise ValueError(f"pad_to={pad_to} < n={len(rows)}")
        if len(rows) == 0:
            return torch.zeros((k, pad_to or 0, self.config.n_class),
                               device=self.device)
        crops, mask_keys = self._qbdc_stage(store, rows, key, k)
        variables = active[0].variables
        with torch.no_grad():
            out = torch.cat([
                short_cnn.qbdc_infer(variables,
                                     crops[lo: lo + self.CROP_BUCKET],
                                     mask_keys, self.config)
                for lo in range(0, crops.shape[0], self.CROP_BUCKET)], dim=1)
        return _keep_columns(out, len(rows) if pad_to is None else pad_to)

    def retrain_cnns(self, store, train_ids, train_y, test_ids, test_y, key,
                     *, n_epochs: int | None = None, tracer=NULL_TRACER,
                     parent=None, user=None) -> list:
        """Retrain every active CNN member on the queried songs
        (``amg_test.py:496-502``), member ``i`` under ``fold_in(key, i)``;
        a member with no improved epoch keeps its variables (and stays
        clean).  Returns the per-member histories."""
        faults.fire("member.retrain", member="__cnn_stack__")
        active = self.active_cnn_members
        best, histories = self.trainer.fit_many(
            [m.variables for m in active], store, train_ids, train_y,
            test_ids, test_y, key,
            n_epochs=(self.trainer.train_config.n_epochs_retrain
                      if n_epochs is None else n_epochs),
            mesh=self.train_mesh, tracer=tracer, parent=parent, user=user)
        for m, b, h in zip(active, best, histories):
            if any(e["improved"] for e in h):
                m.variables = b
        return histories

    # -- cross-user device plans (the fleet's stacked dispatch) ------------

    def _stackable(self, store, song_ids) -> bool:
        return (bool(self.active_cnn_members) and store is not None
                and len(song_ids) > 0 and self.mesh is None)

    def cnn_score_plan(self, store, song_ids, key, *,
                       pad_to: int) -> "CNNScorePlan | None":
        """Stage this committee's CNN scoring pass as a batchable plan
        (:func:`run_device_plans`); ``None`` (no active CNN member, no
        store, no song, window-grid scoring) keeps the per-user path."""
        if not self._stackable(store, song_ids) \
                or self.full_song_hop is not None:
            return None
        return CNNScorePlan(self, store, tuple(song_ids), key, pad_to,
                            len(self.active_cnn_members))

    def eval_plan(self, store, song_ids, key) -> "CNNEvalPlan | None":
        """Stage the evaluation's CNN forward over the test split (no
        staging pad), eligible as :meth:`cnn_score_plan` is."""
        if not self._stackable(store, song_ids) \
                or self.full_song_hop is not None:
            return None
        return CNNEvalPlan(self, store, tuple(song_ids), key, len(song_ids),
                           len(self.active_cnn_members))

    def qbdc_score_plan(self, store, song_ids, key, *, k: int,
                        pad_to: int) -> "QBDCScorePlan | None":
        """qbdc's plan: the first active CNN member under ``k`` dropout
        masks.  ``None`` routes the caller to :meth:`qbdc_pool_probs`,
        whose checks raise the proper errors."""
        if not self._stackable(store, song_ids) or k < 1:
            return None
        return QBDCScorePlan(self, store, tuple(song_ids), key, int(k),
                             pad_to)

    def retrain_plan(self, store, train_ids, train_y, test_ids, test_y, key,
                     *, n_epochs: int | None = None, user=None
                     ) -> "CNNRetrainPlan | None":
        """Stage :meth:`retrain_cnns` as a batchable plan (the cohort
        trains through ``CNNTrainer.fit_many_users``); ``None`` (a host
        store, no active member, an empty split) keeps the per-user path.
        ``user`` names the plan's fits in their spans."""
        if (not self.active_cnn_members or store is None
                or self.mesh is not None or self.train_mesh is not None
                or not hasattr(store, "data")
                or not len(train_ids) or not len(test_ids)):
            return None
        return CNNRetrainPlan(
            self, tuple(self.active_cnn_members), store, tuple(train_ids),
            np.asarray(train_y), tuple(test_ids), np.asarray(test_y), key,
            (self.trainer.train_config.n_epochs_retrain
             if n_epochs is None else int(n_epochs)), user)

    # -- updates -----------------------------------------------------------

    @staticmethod
    def _update(m: Member, X_batch, y_batch, tracer, parent, user) -> None:
        """``m.update`` under its ``member.update`` span."""
        if not tracer.enabled:
            m.update(X_batch, y_batch)
            return
        with tracer.span("member.update", parent=parent, thread_cpu=True,
                         kind=m.kind, user=user):
            m.update(X_batch, y_batch)

    def update_host(self, X_batch: np.ndarray, y_batch: np.ndarray, *,
                    tracer=NULL_TRACER, parent=None, user=None):
        """Incremental update of every active member (``amg_test.py:
        503-509``); a member whose update raises is quarantined."""
        for m in self.active_host_members:
            try:
                faults.fire("member.retrain", member=m.name)
                self._update(m, X_batch, y_batch, tracer, parent, user)
            except Exception as e:
                self.quarantine(m.name, f"retrain failed: {e!r}")

    def update_host_gated(self, X_batch: np.ndarray, y_batch: np.ndarray,
                          X_val: np.ndarray, y_val,
                          before_scores=None, *, tracer=NULL_TRACER,
                          parent=None, user=None) -> dict:
        """Keep each member's update only if its weighted F1 on ``(X_val,
        y_val)`` does not drop, else restore its pre-update state.
        ``before_scores``: the members' F1s on the same split before the
        update, in active order (recomputed when the list shifted).
        Returns ``{member name: kept}``."""
        from consensus_entropy_tpu_torch.al.reporting import weighted_f1

        active = [(i, m) for i, m in enumerate(self.host_members)
                  if m.name not in self.quarantined]
        if before_scores is not None and len(before_scores) != len(active):
            before_scores = None
        kept: dict = {}
        for pos, (i, m) in enumerate(active):
            before = copy.deepcopy(m)
            try:
                f1_before = (before_scores[pos]
                             if before_scores is not None
                             else weighted_f1(y_val, m.predict(X_val)))
                faults.fire("member.retrain", member=m.name)
                self._update(m, X_batch, y_batch, tracer, parent, user)
                worse = weighted_f1(y_val, m.predict(X_val)) < f1_before
            except Exception as e:
                self.host_members[i] = before
                self.quarantine(m.name, f"retrain failed: {e!r}")
                continue
            if worse:
                self.host_members[i] = before
                kept[m.name] = False
            else:
                kept[m.name] = True
        return kept

    # -- persistence -------------------------------------------------------

    @staticmethod
    def member_file(m: Member) -> str:
        """``classifier_{kind}.{name}.npz`` in the port's member format; a
        CNN member is named by its ``stem``, the one its file had, so a
        checkpoint replaces the file the member came from: one file a
        member, whether the workspace came from a registry with
        ``classifier_cnn_res`` folds or from one that saved every trunk as
        ``classifier_cnn``."""
        kind = m.stem if isinstance(m, CNNMember) else m.kind
        return f"classifier_{kind}.{m.name}.npz"

    def save(self, directory: str) -> None:
        self.begin_save(directory)()

    def begin_save(self, directory: str, *, reuse_dir: str | None = None,
                   dtype: str | None = None):
        """Snapshot the committee into ``directory``; returns the deferred
        write (``committee.py:1239-1325``).  Host members are written now
        (the next update changes them in place); CNN members need only
        their variables' references, since retraining rebinds them, so
        their device->host copy and file writes run in the returned
        callable (the checkpointer's thread).  A CNN member that is clean
        against ``reuse_dir``'s file is skipped: the promote leaves that
        file in place.  ``dtype="bfloat16"`` casts on the device before
        the copy.  Quarantined members are skipped, leaving their last
        good file live."""
        os.makedirs(directory, exist_ok=True)
        for m in self.active_host_members:
            p = os.path.join(directory, self.member_file(m))
            m.save(p)
            faults.fire("checkpoint.write", payload=p, member=m.name)

        def provably_current(m):
            if reuse_dir is None or m.ckpt_dirty:
                return False
            target = os.path.abspath(os.path.join(reuse_dir,
                                                  self.member_file(m)))
            return m.ckpt_clean_path == target and os.path.exists(target)

        if dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"unsupported checkpoint dtype {dtype!r}")
        to_write = [m for m in self.active_cnn_members
                    if not provably_current(m)]
        snapshot = [(m, m.variables) for m in to_write]
        for m in to_write:
            m.ckpt_dirty = False
            m.ckpt_clean_path = os.path.abspath(os.path.join(
                reuse_dir if reuse_dir is not None else directory,
                self.member_file(m)))

        def finish():
            import time

            t0 = time.perf_counter()
            fetched = [{k: (t.to(torch.bfloat16) if dtype == "bfloat16"
                            else t).cpu() for k, t in v.items()}
                       for _, v in snapshot]
            t1 = time.perf_counter()
            for (m, _), v in zip(snapshot, fetched):
                p = os.path.join(directory, self.member_file(m))
                m.save(p, variables=v, dtype=dtype)
                faults.fire("checkpoint.write", payload=p)
            return {"fetch_s": t1 - t0, "write_s": time.perf_counter() - t1}

        return finish


# -- cross-user device plans ---------------------------------------------
#
# A session whose committee can stack yields one of these instead of running
# its CNN forward or retrain inline; the fleet scheduler groups them by
# ``group_key()`` and serves each group of two or more with one stacked
# dispatch (:func:`run_device_plans`).  The JAX body is a ``lax.map`` over
# users, which runs them one after another; here that is a loop over users
# of the single-user program, so each user's rows are those of its own call.


def committee_infer_users(user_variables: list, x,
                          config: CNNConfig) -> torch.Tensor:
    """The cross-user committee forward (JAX ``_user_infer_fn``):
    ``(U, M, B, C)`` from one member-variables list per user and ``(U, B,
    L)`` crops."""
    with torch.no_grad():
        return short_cnn.committee_infer_users(user_variables, x, config)


def qbdc_infer_users(user_variables: list, x, mask_keys,
                     config: CNNConfig) -> torch.Tensor:
    """The cross-user qbdc forward (JAX ``_user_qbdc_infer_fn``): ``(U,
    K, B, C)``."""
    with torch.no_grad():
        return short_cnn.qbdc_infer_users(user_variables, x, mask_keys,
                                          config)


def _bucket_slices(crops: torch.Tensor):
    """``(U, n, L)`` crops in ``CROP_BUCKET``-wide slices along the song
    axis, the slices the single path forwards."""
    bucket = Committee.CROP_BUCKET
    return [crops[:, lo: lo + bucket]
            for lo in range(0, crops.shape[1], bucket)]


@dataclasses.dataclass
class CNNScorePlan:
    """One user's staged stored-committee CNN scoring pass (the mc, mix
    and wmc producer).  Crops are drawn at dispatch by the helper the
    single path uses (``Committee._bucketed_crops``), so the crop stream
    is the same on both paths."""

    committee: Committee
    store: object
    song_ids: tuple
    key: object
    pad_to: int
    n_members: int

    fn_key = "cnn_probs"
    #: fired per plan on the stacked path, as the single closure fires it
    fault_point = "pool.score"

    def group_key(self):
        return (self.fn_key, self.committee.config, self.n_members,
                round_up(len(self.song_ids), Committee.CROP_BUCKET),
                self.pad_to, str(self.store.device))

    @staticmethod
    def run_many(plans: list) -> list:
        config = plans[0].committee.config
        crops = torch.stack([
            p.committee._bucketed_crops(p.store, p.store.row_of(p.song_ids),
                                        p.key) for p in plans])
        variables = [[m.variables for m in p.committee.active_cnn_members]
                     for p in plans]
        out = torch.cat([committee_infer_users(variables, x, config)
                         for x in _bucket_slices(crops)], dim=2)
        res = [_keep_columns(out[i], p.pad_to) for i, p in enumerate(plans)]
        if plans[0].fault_point:
            res = [faults.fire(plans[0].fault_point, payload=r)
                   for r in res]
        return res


class CNNEvalPlan(CNNScorePlan):
    """One user's staged evaluation forward over the test split; the single
    path's evaluation fires no fault point, so neither does this."""

    fn_key = "cnn_eval"
    fault_point = None


@dataclasses.dataclass
class QBDCScorePlan:
    """One user's staged qbdc pass: one CNN under ``k`` dropout masks.  The
    key split, the mask keys and the ``acquire.qbdc.masks`` fault point run
    per user through ``Committee._qbdc_stage``, as on the single path."""

    committee: Committee
    store: object
    song_ids: tuple
    key: object
    k: int
    pad_to: int

    fn_key = "qbdc_probs"

    def group_key(self):
        return (self.fn_key, self.committee.config, self.k,
                round_up(len(self.song_ids), Committee.CROP_BUCKET),
                self.pad_to, str(self.store.device))

    @staticmethod
    def run_many(plans: list) -> list:
        config = plans[0].committee.config
        staged = [p.committee._qbdc_stage(
            p.store, p.store.row_of(p.song_ids), p.key, p.k) for p in plans]
        crops = torch.stack([c for c, _ in staged])
        mask_keys = torch.stack([mk for _, mk in staged])
        variables = [p.committee.active_cnn_members[0].variables
                     for p in plans]
        out = torch.cat([qbdc_infer_users(variables, x, mask_keys, config)
                         for x in _bucket_slices(crops)], dim=2)
        return [faults.fire("pool.score",
                            payload=_keep_columns(out[i], p.pad_to))
                for i, p in enumerate(plans)]


@dataclasses.dataclass
class CNNRetrainPlan:
    """One user's staged committee retrain (``Committee.retrain_cnns``).
    The cohort trains through ``CNNTrainer.fit_many_users``; each member's
    best-checkpoint gate and rebinding apply per user in
    :meth:`apply_many`."""

    committee: Committee
    members: tuple
    store: object
    train_ids: tuple
    train_y: np.ndarray
    test_ids: tuple
    test_y: np.ndarray
    key: object
    n_epochs: int
    #: the user the plan trains for, named in its fits' spans
    user: object = None

    fn_key = "cnn_retrain"

    def group_key(self):
        return (self.fn_key, self.committee.config,
                self.committee.trainer.train_config, len(self.members),
                len(self.train_ids), len(self.test_ids), self.n_epochs,
                tuple(self.store.data.shape), str(self.store.device))

    @staticmethod
    def run_many(plans: list, tracer=NULL_TRACER, parent=None) -> list:
        """Pure: fit the cohort, rebind nothing.  The fault point fires
        once per user, as ``retrain_cnns`` fires it on the single path.
        Every fit's spans go under ``parent``."""
        for _ in plans:
            faults.fire("member.retrain", member="__cnn_stack__")
        return plans[0].committee.trainer.fit_many_users(
            [dict(variables_list=[m.variables for m in p.members],
                  store=p.store, train_ids=list(p.train_ids),
                  train_y=p.train_y, test_ids=list(p.test_ids),
                  test_y=p.test_y, key=p.key, user=p.user)
             for p in plans],
            n_epochs=plans[0].n_epochs, tracer=tracer, parent=parent)

    @staticmethod
    def apply_many(plans: list, fitted) -> list:
        """Commit :meth:`run_many`'s result: a member with an improved
        epoch takes its best variables (``retrain_cnns``' gate)."""
        out = []
        for p, (best, histories) in zip(plans, fitted):
            for m, b, h in zip(p.members, best, histories):
                if any(e["improved"] for e in h):
                    m.variables = b
            out.append(histories)
        return out


def _check_plan_group(plans: list) -> type:
    kind = type(plans[0])
    keys = {p.group_key() for p in plans}
    if any(type(p) is not kind for p in plans) or len(keys) != 1:
        raise ValueError(
            f"device-plan group is not homogeneous: {sorted(map(str, keys))}")
    return kind


def stage_device_plans(plans: list, *, tracer=NULL_TRACER, parent=None):
    """The pure half of a stacked plan dispatch: compute the group's
    result, changing nothing; a retrain writes its fits' spans under
    ``parent``."""
    kind = _check_plan_group(plans)
    if kind is CNNRetrainPlan:
        return kind.run_many(plans, tracer, parent)
    return kind.run_many(plans)


def commit_device_plans(plans: list, computed) -> list:
    """The commit half: apply the member changes of the computed result
    (a retrain's rebinding) and return the per-plan results in order."""
    apply = getattr(_check_plan_group(plans), "apply_many", None)
    return apply(plans, computed) if apply is not None else computed


def run_device_plans(plans: list) -> list:
    """Serve one group of same-signature plans as one stacked dispatch;
    per-plan results in order."""
    return commit_device_plans(plans, stage_device_plans(plans))
