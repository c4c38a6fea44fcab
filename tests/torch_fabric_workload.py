"""The port's synthetic multi-host fabric workload (counterpart of
``tests/fabric_workload.py``).

Shared by ``tests/test_torch_fabric.py`` and the worker subprocess
``tests/torch_fabric_worker.py``.  Self-contained and deterministic from
seeds (no pytest, no JAX): a worker process must rebuild exactly the users
the in-process sequential runs were computed from.  The users are the JAX
workload's (``make_data`` draws the same numbers), their committees a
GaussianNB and an SGD member fitted by the port's own ``fit`` on the
CPU; float32 checkpoints, so a resume replays bit for bit.
"""

from __future__ import annotations

import json
import os

import numpy as np


def make_cfg(mode: str = "mc", epochs: int = 2, queries: int = 4):
    from consensus_entropy_tpu_torch.config import ALConfig

    return ALConfig(queries=queries, epochs=epochs, mode=mode, seed=7,
                    ckpt_dtype="float32")


def user_specs(n_users: int, n_songs: int = 30) -> list:
    """``[(seed, user_id, n_songs), ...]``, the JAX workload's users."""
    return [(100 + i, f"u{i}", n_songs) for i in range(int(n_users))]


def make_data(seed: int, uid: str, n_songs: int = 30, f: int = 10):
    """The JAX workload's ``make_data`` draws, into the port's types."""
    from consensus_entropy_tpu_torch.al.loop import UserData
    from consensus_entropy_tpu_torch.models.committee import FramePool

    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4, f)).astype(np.float32) * 2.5
    rows, sids, labels = [], [], {}
    for i in range(n_songs):
        sid = f"song{i:03d}"
        c = int(rng.integers(0, 4))
        labels[sid] = c
        k = int(rng.integers(3, 7))
        rows.append(centers[c]
                    + rng.standard_normal((k, f)).astype(np.float32))
        sids += [sid] * k
    pool = FramePool(np.vstack(rows), sids)
    counts = rng.integers(1, 30, size=(n_songs, 4))
    hc = np.round(counts / counts.sum(1, keepdims=True),
                  3).astype(np.float32)
    return UserData(uid, pool, labels, hc_rows=hc)


def make_committee(data):
    from consensus_entropy_tpu_torch.models.committee import Committee
    from consensus_entropy_tpu_torch.models.members import (
        GNBMember,
        SGDMember,
    )

    X = data.pool.X
    y = np.array([data.labels[s] for s in np.repeat(
        data.pool.song_ids, data.pool.counts)], np.int32)
    return Committee([GNBMember("gnb.it_0").fit(X, y),
                      SGDMember("sgd.it_0", seed=0).fit(X, y)])


def build_entry_factory(ws_root: str, cfg, specs):
    """``build_entry(uid) -> FleetUser`` over per-user workspaces under
    ``ws_root``: a fresh workspace gets a fresh committee, one holding a
    previous host's committed state resumes from its own files."""
    from consensus_entropy_tpu_torch.al import workspace
    from consensus_entropy_tpu_torch.fleet import FleetUser

    by = {uid: (seed, uid, n) for seed, uid, n in specs}

    def build_entry(uid):
        seed, _, n = by[str(uid)]
        data = make_data(seed, str(uid), n_songs=n)
        fp = os.path.join(ws_root, f"fab_{uid}")
        os.makedirs(fp, exist_ok=True)
        if os.path.exists(os.path.join(fp, "al_state.json")):
            committee = workspace.load_committee(fp)
        else:
            committee = make_committee(data)
        return FleetUser(str(uid), committee, data, fp, seed=cfg.seed,
                         committee_factory=lambda fp=fp:
                         workspace.load_committee(fp))

    return build_entry


def sequential_baselines(ws_root: str, cfg, specs) -> dict:
    """``{uid: result}`` of the port's ``ALLoop.run_user`` on the CPU over
    the same users."""
    from consensus_entropy_tpu_torch.al.loop import ALLoop

    out = {}
    loop = ALLoop(cfg, device="cpu")
    for seed, uid, n in specs:
        data = make_data(seed, uid, n_songs=n)
        p = os.path.join(ws_root, f"seq_{uid}")
        os.makedirs(p)
        out[uid] = loop.run_user(make_committee(data), data, p)
    return out


def read_results(fabric_dir: str) -> dict:
    """``{uid: last result record}`` across the workers'
    ``results_<host>.jsonl`` (a torn tail from a killed worker skipped)."""
    recs = []
    for fname in sorted(os.listdir(fabric_dir)):
        if not (fname.startswith("results_") and fname.endswith(".jsonl")):
            continue
        with open(os.path.join(fabric_dir, fname), "rb") as f:
            for raw in f:
                try:
                    rec = json.loads(raw.decode("utf-8"))
                except ValueError:
                    continue
                if isinstance(rec, dict) and "user" in rec:
                    recs.append(rec)
    recs.sort(key=lambda r: r.get("t", 0.0))
    return {r["user"]: r for r in recs}
