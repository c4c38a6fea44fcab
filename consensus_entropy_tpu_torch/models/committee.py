"""The pool in segment layout, the device-member committee and the
user's committee.

Counterpart of ``consensus_entropy_tpu/models/committee.py``:
``FramePool`` (``:50-121``), the closed-form device slice
(``DeviceMemberCommittee``; ``_device_member_probs`` ``:868-918``) and
``Committee`` (``:365-993, 1236-1325``) for host members (GaussianNB,
SGD-logistic): quarantine, ``pool_probs`` over host members and, with
``device_members=True``, over the device slice, the incremental updates
and the checkpoint snapshot.  CNN members wait for ROADMAP A7; the depth
dial waits for the fleet scheduler that sets it (A9).
"""

from __future__ import annotations

import copy
import os
from typing import Sequence

import numpy as np
import torch

from consensus_entropy_tpu_torch.config import NUM_CLASSES
from consensus_entropy_tpu_torch.device import resolve_device
from consensus_entropy_tpu_torch.models.base import Member
from consensus_entropy_tpu_torch.models.members import GNBMember, SGDMember
from consensus_entropy_tpu_torch.ops.device_members import (
    MemberStacks,
    make_device_committee_scorer,
)
from consensus_entropy_tpu_torch.resilience import faults


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
        """Per-segment mean over n+1 boundaries (no segment empty), summed
        in float64 and returned in the input's float type, as the JAX
        package's native ``segment_mean`` does for float32."""
        frame_values = np.asarray(frame_values)
        sums = np.add.reduceat(frame_values, starts[:-1], axis=0,
                               dtype=np.float64)
        return (sums / np.diff(starts)[:, None]).astype(
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


class CommitteeExhaustedError(RuntimeError):
    """Quarantine left fewer members than ``Committee.min_members``."""


class Committee:
    """The user's private committee of host members.

    ``device_members=True`` scores the GaussianNB and SGD-logistic members
    on ``device`` through a :class:`DeviceMemberCommittee` whose stacks are
    rebuilt from the members' parameters at each pass; training stays on
    the host either way.  ``cnn_members`` must be empty: CNN members are
    not ported yet (ROADMAP A7).
    """

    def __init__(self, host_members: list[Member], cnn_members=(), *,
                 device_members: bool = False, min_members: int = 1,
                 device=None):
        if cnn_members:
            raise NotImplementedError(
                "CNN committee members are not ported yet (ROADMAP A7)")
        self.host_members = list(host_members)
        self.device_members = device_members
        #: where the device slice scores (``None`` is the card)
        self.device = resolve_device(device) if device_members else None
        #: quarantine: a member whose update or predict raises, or whose
        #: probabilities go non-finite, leaves the run; the run aborts only
        #: below ``min_members`` survivors
        self.min_members = min_members
        self.quarantined: dict[str, str] = {}
        self._pending_events: list[dict] = []

    # -- quarantine --------------------------------------------------------

    @property
    def active_host_members(self) -> list[Member]:
        return [m for m in self.host_members if m.name not in self.quarantined]

    @property
    def active_size(self) -> int:
        return len(self.active_host_members)

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
                   pad_to: int | None = None):
        """Stacked member probabilities ``(M, N, C)`` over ``song_ids`` in
        committee order, ``(M, pad_to, C)`` with a staging tail of the
        last live song's column.  A committee with a device slice returns
        a tensor on its device; a host-only one returns numpy."""
        n_live = len(song_ids)
        if pad_to is not None and pad_to < n_live:
            raise ValueError(f"pad_to={pad_to} < n={n_live}")
        active = self.active_host_members
        if pad_to is not None and n_live == 0 and active:
            raise ValueError("pad_to requires at least one live song")
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

    # -- updates -----------------------------------------------------------

    def update_host(self, X_batch: np.ndarray, y_batch: np.ndarray):
        """Incremental update of every active member (``amg_test.py:
        503-509``); a member whose update raises is quarantined."""
        for m in self.active_host_members:
            try:
                faults.fire("member.retrain", member=m.name)
                m.update(X_batch, y_batch)
            except Exception as e:
                self.quarantine(m.name, f"retrain failed: {e!r}")

    def update_host_gated(self, X_batch: np.ndarray, y_batch: np.ndarray,
                          X_val: np.ndarray, y_val,
                          before_scores=None) -> dict:
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
                m.update(X_batch, y_batch)
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
        """``classifier_{kind}.{name}`` in the port's member format."""
        return f"classifier_{m.kind}.{m.name}.npz"

    def save(self, directory: str) -> None:
        """Write the active members' files into ``directory``; quarantined
        members are skipped, leaving their last good file live.  (The JAX
        package's ``begin_save`` also defers a CNN member's device fetch;
        host members have none.)"""
        os.makedirs(directory, exist_ok=True)
        for m in self.active_host_members:
            p = os.path.join(directory, self.member_file(m))
            m.save(p)
            faults.fire("checkpoint.write", payload=p, member=m.name)
