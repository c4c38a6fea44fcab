"""Iteration-granularity AL resume state and the two-phase checkpoint.

Counterpart of ``consensus_entropy_tpu/al/state.py``.  ``ALState`` reads
and writes the same ``al_state.json`` as the JAX package (the key as its
threefry ``key_data`` words), so a workspace left by one package resumes
in the other.  Committee files are staged per generation, the state write
is the commit point and :func:`recover_workspace` promotes or discards a
torn stage before any load; promotion keeps the overwritten generation as
a last-good snapshot that :func:`rollback_workspace` can restore.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
import warnings

import numpy as np
import torch

from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.resilience import faults

STATE_FILE = "al_state.json"
STAGING_PREFIX = "_staged_gen"
PREV_DIR = "_prev_good"
PREV_STATE_SUFFIX = ".prev"
#: written LAST into the snapshot; its absence means "incomplete — do not
#: restore"; its content is the generation the snapshot rolls back FROM
PREV_MARKER = "COMPLETE"
#: written FIRST into the snapshot (before any file moves) with the same
#: generation; lets a re-entered promotion (crash mid-promote) tell ITS OWN
#: partial snapshot (keep accumulating into it) from a stale previous
#: generation's (wipe) — wiping its own would gut the snapshot of the
#: already-promoted files and then mark it COMPLETE, re-enabling exactly
#: the mixed-generation rollback the marker exists to prevent
PREV_GEN_MARKER = "GEN"
#: written FIRST by rollback_workspace; recover_workspace finishes an
#: interrupted rollback before anything else touches the workspace
ROLLBACK_INTENT = "_rollback_intent"


@dataclasses.dataclass
class ALState:
    next_epoch: int
    trajectory: list[float]
    train_songs: list[str]
    test_songs: list[str]
    queried: list[list[str]]  # one batch of song ids per completed iteration
    key_data: list            # the key's uint32 words, as a nested list
    key_dtype: str
    mode: str
    seed: int
    queries: int = -1         # -1: legacy state, parameter unknown
    train_size: float = -1.0
    #: wmc mode: per-member reliability weights, keyed by member NAME (the
    #: probs-axis order is reconstructed from the live committee at each
    #: scoring pass, so quarantine-shrunk member lists stay aligned).
    #: None for modes without weights and for legacy states; floats
    #: round-trip JSON exactly, so resume replays bit-identically.
    member_weights: dict | None = None

    def matches(self, *, mode: str, seed: int, queries: int,
                train_size: float) -> bool:
        """Does this state belong to the same experiment definition?"""
        return (self.mode == mode and self.seed == seed
                and self.queries in (-1, queries)
                and self.train_size in (-1.0, train_size))

    def save(self, user_path: str) -> None:
        faults.fire("state.save", epoch=self.next_epoch)
        path = os.path.join(user_path, STATE_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(self), f)
        if os.path.exists(path):
            # retain the outgoing generation's state for rollback_workspace
            # (COPY, not move: a crash between the two renames must never
            # leave the workspace without a live state file)
            prev_tmp = path + PREV_STATE_SUFFIX + ".tmp"
            shutil.copyfile(path, prev_tmp)
            os.replace(prev_tmp, path + PREV_STATE_SUFFIX)
        os.replace(tmp, path)

    @classmethod
    def load(cls, user_path: str) -> "ALState | None":
        return cls._load_file(os.path.join(user_path, STATE_FILE))

    @classmethod
    def _load_file(cls, path: str) -> "ALState | None":
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                payload = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            # A corrupt/truncated state file is treated as NO state: the
            # workspace layer then redoes the user from pristine models
            # (create_user's pre-state-crash path) instead of the decode
            # error killing the whole sweep out of create_user.
            warnings.warn(f"{path}: unreadable AL state ({e!r}); treating "
                          "as absent — the user will be redone")
            return None
        try:
            return cls(**payload)
        except TypeError as e:
            # Parsed cleanly but doesn't fit the dataclass: that is schema
            # drift (a different framework version wrote it), not bit-rot —
            # corruption essentially never yields valid JSON with wrong
            # keys.  Fail LOUD like ALState.matches does for experiment
            # mismatches: silently treating it as absent would wipe every
            # user's completed iterations on the next sweep.
            raise ValueError(
                f"{path} holds an AL state this version cannot read "
                f"({e}); run the matching framework version or delete "
                "the workspace to redo the user") from e

    # -- key round-trip (the JAX package's threefry key data) ---------------

    @staticmethod
    def pack_key(key) -> tuple[list, str]:
        data = prng.key_data(key).cpu().view(torch.int32).numpy().view(
            np.uint32)
        return data.tolist(), str(data.dtype)

    def unpack_key(self, device="cpu"):
        data = np.asarray(self.key_data, dtype=np.dtype(self.key_dtype))
        return prng.wrap_key_data(data, device)


def song_key(s) -> str:
    """Canonical string form of a song id (numpy ints, ints, strings)."""
    return str(s)


def remap_songs(stored: list[str], live_songs) -> list:
    """Map stored string ids back onto the pool's live id objects."""
    by_key = {song_key(s): s for s in live_songs}
    missing = [s for s in stored if s not in by_key]
    if missing:
        raise ValueError(f"resume state references songs not in the pool: "
                         f"{missing[:5]} (pool changed since the run began?)")
    return [by_key[s] for s in stored]


# -- two-phase committee checkpoint --------------------------------------


def staging_dir(user_path: str, generation: int) -> str:
    return os.path.join(user_path, f"{STAGING_PREFIX}{generation}")


def _snapshot_gen(prev_dir: str) -> int | None:
    """Generation recorded in a snapshot's GEN marker (None: no snapshot,
    or one predating the marker — treated as stale either way)."""
    try:
        with open(os.path.join(prev_dir, PREV_GEN_MARKER)) as f:
            return int(f.read())
    except (FileNotFoundError, ValueError):
        return None


def recover_workspace(user_path: str) -> None:
    """Finish or discard a torn committee checkpoint.

    Idempotent; cheap no-op when no staging directory exists.  Must run
    before loading a committee from ``user_path`` (``workspace.
    load_committee`` does so automatically).  An interrupted
    :func:`rollback_workspace` is completed first — its intent marker means
    the rollback already validated and partially applied, and a half-
    rolled-back workspace mixes generations until it finishes.
    """
    intent = os.path.join(user_path, ROLLBACK_INTENT)
    if os.path.exists(intent):
        _finish_rollback(user_path)
    st = ALState.load(user_path)
    for d in sorted(glob.glob(os.path.join(user_path, STAGING_PREFIX + "*"))):
        try:
            gen = int(os.path.basename(d)[len(STAGING_PREFIX):])
        except ValueError:
            shutil.rmtree(d)
            continue
        if st is not None and gen == st.next_epoch:
            # Committed: state references this generation — promote (file
            # renames are idempotent across repeated recoveries).  The
            # files being overwritten are the previous generation: retain
            # them as the last-good rollback snapshot.  The snapshot is
            # rebuilt per promote (a stale one mixes generations) and only
            # valid once its COMPLETE marker lands — a crash mid-promote
            # loses the fallback, never forward progress.
            prev_dir = os.path.join(user_path, PREV_DIR)
            if _snapshot_gen(prev_dir) != gen:
                # stale snapshot from an earlier generation: replace it.
                # A matching GEN marker means a crash interrupted THIS
                # promote's earlier attempt — keep what it already moved
                # (already-promoted files are gone from the staging dir, so
                # their previous-generation copies exist only here) and
                # accumulate the remainder below.
                shutil.rmtree(prev_dir, ignore_errors=True)
                os.makedirs(prev_dir)
                with open(os.path.join(prev_dir, PREV_GEN_MARKER), "w") as f:
                    f.write(str(gen))
            for fname in sorted(os.listdir(d)):
                live = os.path.join(user_path, fname)
                if os.path.exists(live):
                    os.replace(live, os.path.join(prev_dir, fname))
                os.replace(os.path.join(d, fname), live)
            os.rmdir(d)
            with open(os.path.join(prev_dir, PREV_MARKER), "w") as f:
                f.write(str(gen))
        else:
            # Pre-commit stage from a crash before the state write: the
            # epoch will re-run against the (unchanged) live files.
            shutil.rmtree(d)


def rollback_workspace(user_path: str) -> bool:
    """Restore the retained previous-generation snapshot (last-good
    fallback for a corrupt LIVE checkpoint).

    Returns ``True`` when the workspace was stepped back one generation —
    the AL loop's resume then replays that iteration.  Returns ``False``
    (workspace untouched) when no complete, generation-consistent snapshot
    exists; the caller's only remaining option is to abort the user.

    Crash-safe via an intent marker: validation happens up front, then the
    intent file commits the decision, and :func:`recover_workspace`
    finishes an interrupted restore before any subsequent load.
    """
    st = ALState.load(user_path)
    prev_dir = os.path.join(user_path, PREV_DIR)
    marker = os.path.join(prev_dir, PREV_MARKER)
    prev_state = os.path.join(user_path, STATE_FILE + PREV_STATE_SUFFIX)
    if st is None or not os.path.exists(marker) \
            or not os.path.exists(prev_state):
        return False
    try:
        marker_gen = int(open(marker).read())
    except ValueError:
        return False
    prev_st = ALState._load_file(prev_state)
    if (marker_gen != st.next_epoch or prev_st is None
            or prev_st.next_epoch != st.next_epoch - 1):
        # snapshot belongs to some other generation pair — restoring it
        # would mix generations and silently diverge the replay
        return False
    with open(os.path.join(user_path, ROLLBACK_INTENT), "w") as f:
        f.write(str(marker_gen))
    _finish_rollback(user_path)
    return True


def _finish_rollback(user_path: str) -> None:
    """Apply (or re-apply after a crash) a committed rollback intent.
    Every step is idempotent: member moves skip already-moved files, the
    state restore skips when the previous state was already promoted."""
    prev_dir = os.path.join(user_path, PREV_DIR)
    prev_state = os.path.join(user_path, STATE_FILE + PREV_STATE_SUFFIX)
    if os.path.isdir(prev_dir):
        for fname in sorted(os.listdir(prev_dir)):
            if fname in (PREV_MARKER, PREV_GEN_MARKER):
                continue
            os.replace(os.path.join(prev_dir, fname),
                       os.path.join(user_path, fname))
    if os.path.exists(prev_state):
        os.replace(prev_state, os.path.join(user_path, STATE_FILE))
    for marker in (PREV_MARKER, PREV_GEN_MARKER):
        mpath = os.path.join(prev_dir, marker)
        if os.path.exists(mpath):
            os.remove(mpath)
    if os.path.isdir(prev_dir):
        os.rmdir(prev_dir)
    os.remove(os.path.join(user_path, ROLLBACK_INTENT))
