"""The pool in segment layout and the closed-form device-member committee.

Counterpart of ``consensus_entropy_tpu/models/committee.py``: ``FramePool``
(``:50-121``) and the device-member slice of ``Committee.pool_probs``
(``:591-664``, ``_device_member_probs`` ``:868-918``).  The members are
stacked parameter tensors (:class:`~consensus_entropy_tpu_torch.ops.
device_members.MemberStacks`), not fitted estimators, so scoring needs no
scikit-learn.  Host members, CNN members and quarantine are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from consensus_entropy_tpu_torch.ops.device_members import (
    MemberStacks,
    make_device_committee_scorer,
)


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
