"""The per-user active-learning loop (``AMG_Tester.run``,
``amg_test.py:344-539``).

Counterpart of ``consensus_entropy_tpu/al/loop.py``.  Per user: a grouped
85/15 song split, then ``epochs`` iterations of [score the pool -> query
the top q -> reveal the user's labels -> update the host members and
retrain the CNN members -> evaluate] after a baseline evaluation.  The iteration body is
``fleet.session.UserSession``; this module keeps the sequential surface
(``ALLoop``), the per-user data (``UserData``, ``SplitData``,
``grouped_split``, ``query_batch``) and the checkpoint writer
(``AsyncCheckpointer``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from consensus_entropy_tpu_torch.config import ALConfig
from consensus_entropy_tpu_torch.data.audio import DeviceWaveformStore
from consensus_entropy_tpu_torch.device import resolve_device
from consensus_entropy_tpu_torch.models.committee import Committee, FramePool
from consensus_entropy_tpu_torch.obs.metrics import StepTimer


class AsyncCheckpointer:
    """One background writer per user session.

    Each submitted job keeps the two-phase commit's order (member files ->
    state write -> promote); ``submit`` joins the previous job first, so
    jobs never overlap and a crash leaves what the synchronous order
    would.  ``executor``: a shared ``ThreadPoolExecutor`` (the fleet's,
    so concurrent sessions' writes overlap while each session's stay in
    order); ``None`` gives the session a private one-worker pool.  A shared
    executor is left running by ``close`` for its owner to shut down."""

    def __init__(self, executor=None):
        from concurrent.futures import ThreadPoolExecutor

        self._owns_pool = executor is None
        self._pool = (ThreadPoolExecutor(max_workers=1)
                      if executor is None else executor)
        self._future = None
        self._closed = False

    def submit(self, fn) -> None:
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self.wait()
        self._future = self._pool.submit(fn)

    def wait(self) -> None:
        if self._future is not None:
            future, self._future = self._future, None
            future.result()

    def close(self) -> None:
        """Join the pending job and release the worker thread."""
        self._closed = True
        try:
            self.wait()
        finally:
            if self._owns_pool:
                self._pool.shutdown(wait=False)

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        """On success a deferred write error surfaces; on the error path
        closing is best-effort, so the loop's own error is what
        propagates."""
        if exc_type is None:
            self.close()
        else:
            try:
                self.close()
            except BaseException:
                pass
        return False


@dataclasses.dataclass
class UserData:
    """Everything the loop needs for one user."""

    user_id: object
    pool: FramePool  # frames of the user's annotated songs (scaled)
    labels: Mapping  # song id -> class 0..3 (the user's annotations)
    hc_rows: np.ndarray | None = None  # hc rows aligned with pool.song_ids
    store: DeviceWaveformStore | None = None  # audio (CNN committees only)


@dataclasses.dataclass
class SplitData:
    train_songs: list
    test_songs: list
    X_test: np.ndarray  # test frames (host members evaluate per frame,
    y_test_frames: np.ndarray  # amg_test.py:411-413)
    y_test_songs: np.ndarray  # song-level labels (amg_test.py:406-408)


def split_from_songs(pool: FramePool, labels: Mapping, train_songs: list,
                     test_songs: list) -> SplitData:
    """``SplitData`` from chosen train/test song lists."""
    rows = pool.rows_for_songs(test_songs)
    X_test = pool.X[rows]
    # frames repeat their song's label (the split lists songs in pool
    # order, as the rows are)
    y_test_frames = np.asarray(
        [labels[s] for s in test_songs for _ in range(pool.count_of(s))],
        np.int32)
    y_test_songs = np.array([labels[s] for s in test_songs], np.int32)
    return SplitData(train_songs, test_songs, X_test, y_test_frames,
                     y_test_songs)


def query_batch(pool: FramePool, labels: Mapping, q_songs):
    """Frames and per-frame labels of a query batch, both in pool order
    (``amg_test.py:491-493``), whatever the ranking's order."""
    q_set = set(q_songs)
    ordered = [s for s in pool.song_ids if s in q_set]
    X = pool.X[pool.rows_for_songs(ordered)]
    y = np.asarray(
        [labels[s] for s in ordered for _ in range(pool.count_of(s))],
        np.int32)
    return X, y


def grouped_split(pool: FramePool, labels: Mapping, train_size: float,
                  rng: np.random.Generator) -> SplitData:
    """Song-grouped shuffle split (``GroupShuffleSplit`` semantics,
    ``amg_test.py:363-366``): ``train_size`` of the songs, in pool
    order."""
    songs = list(pool.song_ids)
    perm = rng.permutation(len(songs))
    n_train = int(round(train_size * len(songs)))
    train_songs = [songs[i] for i in sorted(perm[:n_train])]
    test_songs = [songs[i] for i in sorted(perm[n_train:])]
    return split_from_songs(pool, labels, train_songs, test_songs)


class ALLoop:
    """The sequential AL loop.  ``retrain_epochs`` overrides the CNN
    members' retrain epochs an iteration; ``pad_pool_to`` pads every
    user's pool to one width; ``fuse_step`` stages the fused select (one
    call: score -> top-k -> mask update); ``device`` is where the
    acquisition runs (``None`` is the card).  ``mesh``: a pool-axis mesh
    the acquisition runs sharded across (its first device then stands for
    ``device``); pair it with ``Committee(mesh=...)`` so the CNN forward
    shards too."""

    def __init__(self, config: ALConfig, *, tie_break: str = "fast",
                 retrain_epochs: int | None = None,
                 pad_pool_to: int | None = None, fuse_step: bool = True,
                 device=None, mesh=None):
        self.config = config
        self.tie_break = tie_break
        self.retrain_epochs = retrain_epochs
        self.pad_pool_to = pad_pool_to
        self.fuse_step = fuse_step
        self.mesh = mesh
        self.device = (mesh.device_list[0] if mesh is not None
                       and device is None else resolve_device(device))

    def run_user(self, committee: Committee, data: UserData, user_path: str,
                 *, seed: int | None = None, resume: bool = True,
                 timer: StepTimer | None = None, preemption=None) -> dict:
        """Run (or resume) one user; returns ``{"user", "mode",
        "trajectory", "final_mean_f1"}``.  ``preemption``: an object with a
        boolean ``requested`` (``PreemptionGuard``); when set, the loop
        commits the in-flight iteration and raises ``Preempted``."""
        from consensus_entropy_tpu_torch.fleet.session import (
            UserSession,
            drive_inline,
        )

        session = UserSession(
            self.config, committee, data, user_path, seed=seed,
            tie_break=self.tie_break, retrain_epochs=self.retrain_epochs,
            pad_pool_to=self.pad_pool_to,
            resume=resume, timer=timer, preemption=preemption,
            fuse_step=self.fuse_step, device=self.device, mesh=self.mesh)
        return drive_inline(session)
