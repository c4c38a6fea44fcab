"""A cell's inputs, made from the seed: the clip store, the users, the
committee's starting members.

- The store: the configuration's songs as seeded noise clips (std 0.1) on
  the device, drawn by one ``torch.Generator`` call there.
- The CNN members' starting weights: one normal draw on the device for
  all members' kernels, each kernel scaled by ``sqrt(1 / fan_in)``;
  biases 0, BatchNorm scale 1, shift 0, mean 0, variance 1.  There is no
  pre-training: a random start retrains at the same cost.  The names and
  shapes are the reference's (``benchmark.reference.trunk``), handed to
  the system under test and to the reference alike.
- The host members (GaussianNB, SGD, the xgb slot's boosted trees), each
  fitted once by the system under test on its own seeded rows around the
  class centres (kept, for the reference to fit them again), then copied
  to every user.
- Each user: a seeded choice of the store's songs, each with seeded
  frames of the configuration's features around its label's centre
  (a copy of the port's ``chip_smoke.full_user``), and a session seed.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark.reference.trunk import TrunkConfig, variable_shapes


@dataclasses.dataclass
class User:
    user_id: str
    seed: int
    songs: list
    labels: dict
    frames: np.ndarray  # (songs, frames a song, F), float32


@dataclasses.dataclass
class Inputs:
    data: torch.Tensor  # (songs, samples) waveforms on the device
    ids: list  # song ids, row order of ``data``
    cnn: list  # each CNN member's starting variables
    host: list  # fitted host members (the system under test's objects)
    users: list  # User, in admission order
    #: each host member's ``(kind, rows, labels, random_state)``, the rows
    #: it was fitted on, handed to the reference too
    host_rows: list


def _seeds(seed: int, n: int) -> list:
    return [int(s) for s in np.random.SeedSequence(
        int(seed)).generate_state(n, np.uint32)]


def labelled_rows(rng, centers, n):
    """``n`` frames around the class centres, every class present."""
    y = np.arange(n) % centers.shape[0]
    rng.shuffle(y)
    x = rng.standard_normal((n, centers.shape[1]), np.float32) + centers[y]
    return x.astype(np.float32), y


def cnn_variables(tcfg: TrunkConfig, members: int, gen, device) -> list:
    shapes = variable_shapes(tcfg)
    kernels = {k: s for k, s in shapes.items()
               if k.endswith(".weight") and len(s) >= 2}
    total = sum(int(np.prod(s)) for s in kernels.values())
    draw = torch.randn((members, total), generator=gen, device=device)
    out = []
    for m in range(members):
        v, at = {}, 0
        for k, s in shapes.items():
            if k in kernels:
                n = int(np.prod(s))
                v[k] = draw[m, at: at + n].reshape(s).mul(
                    float(np.sqrt(1.0 / np.prod(s[1:]))))
                at += n
            elif k.endswith(".running_var") or (
                    k.endswith(".weight") and "bn" in k):
                v[k] = torch.ones(s, device=device)
            else:
                v[k] = torch.zeros(s, device=device)
        out.append(v)
    return out


def host_rows(cfg: dict, centers: np.ndarray, seed: int) -> list:
    """Each host member's ``(kind, rows, labels, random_state)``: its own
    seeded rows around the class centres; an SGD member's random state is
    its index."""
    n, rows = cfg["members"], cfg["host_fit_rows"]
    kinds = [(k, i) for k in ("gnb", "sgd", "xgb") for i in range(n[k])]
    seeds = _seeds(seed, len(kinds))
    return [(k, *labelled_rows(np.random.default_rng(s), centers, rows[k]),
             i if k == "sgd" else None) for (k, i), s in zip(kinds, seeds)]


def host_members(specs: list) -> list:
    """The configuration's GaussianNB, SGD and boosted-tree members, each
    fitted by the system under test on its rows (:func:`host_rows`); the
    boosted trees' fits run side by side (the core releases the
    interpreter lock), each with its share of the cores."""
    from consensus_entropy_tpu_torch import native
    from consensus_entropy_tpu_torch.models.gbdt import NativeGBDTMember
    from consensus_entropy_tpu_torch.models.members import (
        GNBMember,
        SGDMember,
    )

    out, xgb, seen = [], [], {}
    for kind, x, y, state in specs:
        seen[kind] = seen.get(kind, -1) + 1
        name = f"{kind}.it_{seen[kind]}"
        if kind == "gnb":
            out.append(GNBMember(name).fit(x, y))
        elif kind == "sgd":
            out.append(SGDMember(name, seed=state).fit(x, y))
        else:
            xgb.append((name, x, y))
    workers = max(1, len(xgb))
    with ThreadPoolExecutor(
            workers, initializer=native.limit_threads,
            initargs=(max(1, (os.cpu_count() or 4) // workers),)) as pool:
        out += list(pool.map(
            lambda a: NativeGBDTMember(a[0]).fit(a[1], a[2]), xgb))
    return out


def build(cfg: dict, traffic: dict, seed: int, device) -> Inputs:
    store_seed, weight_seed, center_seed, host_seed, user_seed = _seeds(
        seed, 5)
    st = cfg["store"]
    n_songs, n_samples = st["songs"], st["seconds"] * st["sample_rate"]
    gen = torch.Generator(device=device).manual_seed(store_seed)
    data = torch.randn((n_songs, n_samples), generator=gen,
                       device=device).mul_(0.1)
    ids = list(range(1, n_songs + 1))
    tcfg = TrunkConfig.from_dict(cfg["cnn"])
    gen = torch.Generator(device=device).manual_seed(weight_seed)
    cnn = cnn_variables(tcfg, cfg["members"]["cnn"], gen, device)
    feats = cfg["features"]
    centers = np.random.default_rng(center_seed).normal(
        0, feats["centre_sd"], (feats["C"], feats["F"])).astype(np.float32)
    rows = host_rows(cfg, centers, host_seed)
    host = host_members(rows)
    rng = np.random.default_rng(user_seed)
    user = cfg["user"]
    users = []
    for u in range(traffic["users"] + traffic["spare_users"]):
        songs = sorted(rng.choice(ids, user["songs"], replace=False)
                       .tolist())
        y = rng.integers(0, feats["C"], len(songs))
        frames = (rng.standard_normal(
            (len(songs), user["frames"], feats["F"]), np.float32)
            + centers[y][:, None, :])
        users.append(User(f"u{u}", int(rng.integers(0, 2 ** 31)), songs,
                          {s: int(c) for s, c in zip(songs, y)}, frames))
    return Inputs(data, ids, cnn, host, users, rows)


def program_configs(cfg: dict, traffic: dict):
    """The system under test's CNN and AL configurations of a cell."""
    from consensus_entropy_tpu_torch.config import ALConfig, CNNConfig

    names = {f.name for f in dataclasses.fields(CNNConfig)}
    cnn = CNNConfig(**{k: v for k, v in cfg["cnn"].items() if k in names})
    al = ALConfig(queries=traffic["queries"], epochs=traffic["epochs"],
                  mode=traffic["mode"], train_size=cfg["user"]["train_size"])
    return cnn, al


def committee(inp: Inputs, cfg: dict, traffic: dict, device):
    """A fresh committee of the configuration's starting members."""
    from consensus_entropy_tpu_torch.models.committee import (
        CNNMember,
        Committee,
    )

    cnn_cfg, _ = program_configs(cfg, traffic)
    cnns = [CNNMember(f"cnn.it_{i}", {k: t.clone() for k, t in v.items()},
                      cnn_cfg) for i, v in enumerate(inp.cnn)]
    return Committee(copy.deepcopy(inp.host), cnns, cnn_cfg,
                     device=device, full_song_hop=traffic["full_song_hop"])


def user_data(inp: Inputs, user: User, store):
    from consensus_entropy_tpu_torch.al.loop import UserData
    from consensus_entropy_tpu_torch.models.committee import FramePool

    n, k, f = user.frames.shape
    pool = FramePool(user.frames.reshape(n * k, f),
                     np.repeat(user.songs, k))
    return UserData(user.user_id, pool, user.labels, store=store)
