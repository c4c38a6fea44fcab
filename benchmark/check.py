"""What decides ``correct``: the timed path's answers held to the plain
reference.

At the start of every AL iteration that the window sees, the driver keeps
a copy of the user's committee as the iteration will use it
(:func:`snapshot`: the CNN members' variables copied on the device, the
host members' fitted arrays copied).  The reference follows the CNN
members from those copies, as a served model's reference follows the
tokens it served: float32 CNN training drifts apart by rounding within a
few epochs, so an independent run would not agree with any sound run
after the first retrain.  The host members it works out by itself: the
GaussianNB and SGD members fitted again from the inputs' rows and updated
with each iteration's queried rows, the boosted trees' bin edges worked
out again and every tree held to the rows it was grown from
(``benchmark.reference.host``).  From the seed it works out the split, the
live songs, the key stream and every crop, and compares:

- ``select_gap``: the consensus entropy of every live song, recomputed
  (the CNN forward over the iteration's crops or window grid from the kept
  CNN members, the host members' predictions, their per-song mean), and
  how far the songs the system queried lie below the ``q``-th best of them
  (0 when they are the reference's top ``q``): the CNN forward, the host
  predictions, the entropy and the top-q selection;
- ``retrain_gap`` and ``retrain_one_epoch``: for an iteration whose next
  state was also kept, the reference retrains the kept CNN members on the
  queried songs with the iteration's own draws, and each member's
  retrained variables are matched to the nearest epoch of the reference's
  trajectory (by the median variable's gap).  Which epoch a sound retrain
  keeps, float32 rounding decides: its validation scores drift from the
  reference's, so it is not held to the reference's best epoch.  For
  each variable, the gap is the norm of the difference of the two changes
  over the norm of the reference's change (or the median variable's,
  whichever is larger); parameters whose first gradient is under a
  thousandth of the median parameter's move by round-off alone and are
  left out.  ``retrain_gap`` is the worst variable's gap of the member
  that matches best: rounding grows with the epochs (a member kept at a
  late epoch reads up to about 0.6), while a member kept early matches
  to about 1%, and a broken retrain (half of each batch, its state left
  unchanged) matches in none.  ``retrain_one_epoch`` is 1 over the number
  of different epochs the compared members kept: a retrain that keeps a
  fixed epoch (one epoch run, the last epoch kept) reads 1;
- ``f1_gap``: for the same iterations, each member's weighted F1 on the
  test split that the system reported, against the reference's from the
  state after the iteration (the evaluation forward from the kept CNN
  members, the host members' predictions, the F1); a CNN member's near
  ties (class scores within 1e-4) may go either way;
- ``host_gap``: the host members, worst first: each GaussianNB and SGD
  member's arrays at the start and the end of the iteration against the
  reference's, over their largest value; each boosted-tree member's bin
  edges, the forest it kept, and each tree the update grew against its
  rows (its leaves to ``-G/(H+lambda)``, its splits, on a sample of the
  trees, to the best gain); once a run, the starting forests alike.

The iterations compared are a sample drawn from the seed, of at most the
limits' ``select_checks``, ``f1_checks`` and ``retrain_checks``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmark.reference import host as ref_host
from benchmark.reference import prng, select, train, trunk

NUMBERS = ("select_gap", "f1_gap", "retrain_gap", "retrain_one_epoch",
           "host_gap")


def host_state(m) -> dict:
    """A host member's fitted arrays, copied."""
    if m.kind == "gnb":
        return {"kind": "gnb", "theta": m.theta_.copy(), "var": m.var_.copy(),
                "count": m.class_count_.copy(),
                "prior": m.class_prior_.copy(),
                "classes": np.asarray(m.classes_).copy()}
    if m.kind == "sgd":
        return {"kind": "sgd", "coef": m.coef_.copy(),
                "intercept": np.asarray(m.intercept_).copy(),
                "classes": np.asarray(m.classes_).copy()}
    if m.kind == "xgb":
        g = m.model
        return {"kind": "xgb", "edges": [e.copy() for e in m.binner.edges],
                "feature": g._feature.copy(), "threshold": g._threshold.copy(),
                "value": g._value.copy(), "tree_class": g._tree_class.copy(),
                "lr": ref_host.GBDT["lr"]}
    raise ValueError(f"no state copy for member kind {m.kind!r}")


def snapshot(committee) -> dict:
    """A copy of the committee as the next iteration uses it.  The CNN
    members' variables are copied on their device in one call (each call
    into torch hands the interpreter lock to the busy host workers)."""
    cnn = [m.variables for m in committee.active_cnn_members]
    flat = torch._foreach_mul([t for v in cnn for t in v.values()], 1)
    copies, at = [], 0
    for v in cnn:
        copies.append(dict(zip(v, flat[at: at + len(v)])))
        at += len(v)
    return {"cnn": copies,
            "host": [host_state(m) for m in committee.active_host_members]}


def epoch_keys(seed: int, epoch: int) -> list:
    """The session's keys of ``epoch``: score, select, retrain, evaluate
    (after the baseline evaluation's one split, four an iteration)."""
    k = prng.key(seed)
    for _ in range(1 + 4 * epoch):
        k = prng.split(k)[0]
    out = []
    for _ in range(4):
        k, s = prng.split(k)
        out.append(s)
    return out


def reported(user_path: str) -> dict:
    """``{epoch: (queried songs, members' F1s)}`` of each iteration the
    user's ``metrics.jsonl`` summarises."""
    out = {}
    with open(os.path.join(user_path, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("epoch", -1) >= 0 and "queried" in rec:
                out[rec["epoch"]] = ([int(s) for s in rec["queried"]],
                                     rec["f1"])
    return out


def _one_hot(labels, n_class):
    y = np.zeros((len(labels), n_class), np.float32)
    y[np.arange(len(labels)), labels] = 1.0
    return y


class Reference:
    """The reference's view of one cell's inputs."""

    def __init__(self, inp, cfg: dict, traffic: dict):
        self.inp, self.cfg, self.traffic = inp, cfg, traffic
        self.tcfg = trunk.TrunkConfig.from_dict(cfg["cnn"])
        self.row = {s: i for i, s in enumerate(inp.ids)}
        self.lengths = np.full(len(inp.ids), inp.data.shape[1], np.int64)
        self.n_class = cfg["features"]["C"]
        # the host members fitted again from their rows; the boosted
        # trees' bin edges worked out again
        self.host0 = []
        for kind, x, y, state in inp.host_rows:
            if kind == "gnb":
                self.host0.append(ref_host.gnb_fit(x, y))
            elif kind == "sgd":
                self.host0.append(ref_host.sgd_fit(x, y, state))
            else:
                self.host0.append({"kind": "xgb",
                                   "edges": ref_host.quantile_edges(x)})
        self._host: dict = {}

    def split(self, user):
        n = len(user.songs)
        perm = np.random.default_rng(user.seed).permutation(n)
        n_train = int(round(self.cfg["user"]["train_size"] * n))
        return ([user.songs[i] for i in sorted(perm[:n_train])],
                [user.songs[i] for i in sorted(perm[n_train:])])

    def rows(self, user, songs):
        """The host update's ``(X, y)`` of the queried ``songs``: their
        frames in the user's song order."""
        qs = set(songs)
        ordered = [s for s in user.songs if s in qs]
        x = np.concatenate([user.frames[user.songs.index(s)]
                            for s in ordered])
        y = np.repeat([user.labels[s] for s in ordered],
                      user.frames.shape[1]).astype(np.int32)
        return x, y

    def host_states(self, user, picks: dict, epoch: int) -> list:
        """The GaussianNB and SGD members' states at the start of
        ``epoch``: the refit, updated with each earlier iteration's
        queried rows (``None`` for a boosted-tree member)."""
        key = (user.user_id, epoch)
        if key not in self._host:
            if epoch <= 0:
                self._host[key] = [None if st["kind"] == "xgb" else st
                                   for st in self.host0]
            else:
                x, y = self.rows(user, picks[epoch - 1])
                self._host[key] = [
                    None if st is None else
                    ref_host.gnb_update(st, x, y) if st["kind"] == "gnb"
                    else ref_host.sgd_update(st, x, y)
                    for st in self.host_states(user, picks, epoch - 1)]
        return self._host[key]

    def cnn_probs(self, variables: list, songs, key, tf32=False):
        """``(M, n, C)``: one crop a song from ``key`` (the crop bucket's
        padding draws nothing the real rows use), or the mean over each
        song's window grid."""
        rows = np.array([self.row[s] for s in songs])
        data, L = self.inp.data, self.tcfg.input_length
        hop = self.traffic["full_song_hop"]
        if hop is None:
            n_pad = -(-len(rows) // 256) * 256
            u = prng.uniform(key, n_pad)[: len(rows)]
            x = train.crops(data, rows, u, L, self.lengths)
            return torch.stack([trunk.infer(v, x, self.tcfg, tf32=tf32)
                                for v in variables]).cpu().numpy()
        n_win = (data.shape[1] - L) // hop + 1
        out = []
        for v in variables:
            per = []
            for lo in range(0, len(rows), 8):
                r = torch.as_tensor(rows[lo: lo + 8], device=data.device)
                w = data[r].unfold(1, L, hop)[:, :n_win]
                p = trunk.infer(v, w.reshape(-1, L), self.tcfg, tf32=tf32)
                per.append(p.reshape(len(r), n_win, -1).mean(dim=1))
            out.append(torch.cat(per).cpu().numpy())
        return np.stack(out)

    def host_probs(self, states: list, user, songs):
        idx = [user.songs.index(s) for s in songs]
        x = user.frames[idx]
        flat = x.reshape(-1, x.shape[-1])
        counts = [x.shape[1]] * len(idx)
        return np.stack([ref_host.segment_mean(
            ref_host.member_proba(st, flat, self.n_class,
                                  self.inp.data.device), counts)
            for st in states])

    def entropies(self, cnn, host, user, songs, key, tf32=False):
        probs = np.concatenate([self.cnn_probs(cnn, songs, key, tf32),
                                self.host_probs(host, user, songs)])
        return select.consensus_entropy(probs)


def _mixed(kept: list, ref: list) -> list:
    """The reference's host states where it has them (GaussianNB, SGD),
    the kept ones where it holds them tree by tree (boosted trees)."""
    return [k if r is None else r for k, r in zip(kept, ref)]


def live_songs(train_songs, picks: dict, epoch: int) -> list:
    before = {s for e, q in picks.items() if e < epoch for s in q}
    return [s for s in train_songs if s not in before]


def change_gaps(pre: dict, post: dict, ref: dict, keys,
                floor: float = 0.0) -> np.ndarray:
    """Each variable's norm of the difference between the system's and
    the reference's change, over the norm of the reference's change (or
    the median variable's, whichever is larger; ``floor`` where the
    reference's state is ``pre`` itself)."""
    d_ref = np.array([float((ref[k] - pre[k]).double().norm())
                      for k in keys])
    diff = np.array([float((post[k] - ref[k]).double().norm())
                     for k in keys])
    med = float(np.median(d_ref))
    return diff / np.maximum(d_ref, med if med > 0 else max(floor, 1e-30))


def loud(first_grad: dict, keys) -> list:
    """The variables a retrain moves: parameters whose first gradient is
    at least a thousandth of the median parameter's, and the statistics."""
    floor = 1e-3 * float(np.median(list(first_grad.values())))
    return [k for k in keys if first_grad.get(k, floor) >= floor]


def nearest_epoch(pre: dict, post: dict, trajectory: list,
                  first_grad: dict) -> tuple:
    """``(epoch, gap, moved)``: the epoch of the reference's trajectory
    nearest ``post`` by the median variable's :func:`change_gaps` (1 the
    first; 0 where the starting state is nearer than any), the worst
    variable's gap to the nearest epoch, and whether any epoch scored
    above the starting 0 (where none did, the reference keeps its start,
    and ``gap`` is ``post``'s to it)."""
    keys = loud(first_grad, list(pre))
    floor = float(np.median(change_gaps(pre, trajectory[-1][1], pre, keys,
                                        1.0)))
    start = change_gaps(pre, post, pre, keys, floor)
    if max(sc for sc, _ in trajectory) <= 0:
        return 0, float(start.max()), False
    med, worst, epoch = min(
        (float(np.median(g)), float(g.max()), e) for e, g in (
            (e, change_gaps(pre, post, st, keys, floor))
            for e, (_, st) in enumerate(trajectory, 1)))
    return (0 if float(np.median(start)) < med else epoch), worst, True


def retrain_numbers(matches: list) -> tuple:
    """``(retrain_gap, retrain_one_epoch)`` of the compared members'
    :func:`nearest_epoch` readings: the least gap, and 1 over the number
    of different epochs kept (1 where none was).  A member whose
    reference no epoch improved keeps its start on both sides and shows
    nothing of the retrain: only where every member is such is it read."""
    moved = [(e, g) for e, g, m in matches if m]
    if not moved:
        return max(g for _, g, _ in matches), 0.0
    kept = {e for e, _ in moved if e > 0}
    return min(g for _, g in moved), 1.0 / max(1, len(kept))


def _rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - b))
                 / max(float(np.max(np.abs(b))), 1e-30))


def state_gap(got: dict, want: dict) -> float:
    """A GaussianNB or SGD member's arrays against the reference's."""
    fields = ("theta", "var", "count") if want["kind"] == "gnb" \
        else ("coef", "intercept")
    return max(_rel(got[f], want[f]) for f in fields)


def _edges_gap(got: list, want: list) -> float:
    same = len(got) == len(want) and all(
        np.array_equal(a, b) for a, b in zip(got, want))
    return 0.0 if same else 1.0


#: boosted trees of an update (or of a starting forest) whose splits are
#: checked, drawn from the seed; every tree's leaves are
SPLIT_CHECKS = 40


def forest_gap(ref: Reference, pre: dict, post: dict, want_edges, x, y,
               rng, *, lam_fault: bool = False) -> float:
    """A boosted-tree member's update: its edges, the forest it kept, and
    each tree it grew on the batch ``(x, y)`` (splits on a sample of
    them)."""
    n = pre["feature"].shape[0]
    gap = max(_edges_gap(pre["edges"], want_edges),
              _edges_gap(post["edges"], want_edges))
    if post["feature"].shape[0] != n + ref_host.GBDT["rounds"] * ref.n_class \
            or not all(np.array_equal(pre[f], post[f][:n]) for f in (
                "feature", "threshold", "value", "tree_class")):
        return 1.0
    grown = post["feature"].shape[0] - n
    sample = set((n + rng.choice(grown, min(grown, SPLIT_CHECKS),
                                 replace=False)).tolist())
    return max(gap, ref_host.boost_gap(
        ref_host.binned(x, want_edges), y, post, n, ref.n_class,
        ref_host.GBDT["lr"], split_trees=sample, lam_fault=lam_fault))


def start_gap(ref: Reference, rng) -> float:
    """The system's starting host members against the reference's: the
    GaussianNB and SGD fits, and each boosted-tree member's edges and
    forest on its rows."""
    worst = 0.0
    for m, want, (kind, x, y, _) in zip(ref.inp.host, ref.host0,
                                        ref.inp.host_rows):
        got = host_state(m)
        if kind != "xgb":
            worst = max(worst, state_gap(got, want))
            continue
        grown = got["feature"].shape[0]
        if grown != ref_host.GBDT["rounds"] * ref.n_class:
            return 1.0
        sample = set(rng.choice(grown, min(grown, SPLIT_CHECKS),
                                replace=False).tolist())
        worst = max(worst, _edges_gap(got["edges"], want["edges"]),
                    ref_host.boost_gap(ref_host.binned(x, want["edges"]), y,
                                       got, 0, ref.n_class,
                                       ref_host.GBDT["lr"],
                                       split_trees=sample))
    return worst


def host_gap(ref: Reference, user, picks: dict, epoch: int, pre: list,
             post: list, rng, fault: str | None = None) -> float:
    """The host members over one iteration: each GaussianNB and SGD
    member at its start and its end against the reference's, each
    boosted-tree member's update by :func:`forest_gap`.  ``fault``
    (``gnb``, ``sgd`` or ``gbdt``): that kind's update planted with a
    fault (``benchmark.faults``) put in the system's place, the reading
    of a broken system."""
    x, y = ref.rows(user, picks[epoch])
    before = ref.host_states(user, picks, epoch)
    after = ref.host_states(user, picks, epoch + 1)
    worst = 0.0
    for i, (a, b, r0, r1) in enumerate(zip(pre, post, before, after)):
        if r0 is None:
            worst = max(worst, forest_gap(
                ref, a, b, ref.host0[i]["edges"], x, y, rng,
                lam_fault=fault == "gbdt"))
            continue
        if fault == "gnb" and r0["kind"] == "gnb":
            b = ref_host.gnb_update({**r0, "count": r0["count"] * 0}, x, y)
        elif fault == "sgd" and r0["kind"] == "sgd":
            b = ref_host.sgd_update(r0, x, y, fault=True)
        worst = max(worst, state_gap(a, r0), state_gap(b, r1))
    return worst


#: a CNN member's class scores closer than this (a probability) are a
#: tie that float32 rounding may split either way
TIE = 1e-4


def _f1_choices(y, probs) -> list:
    """The weighted F1s of ``probs``' predictions, each near tie (top two
    scores within :data:`TIE`) resolved both ways (at most 2**10)."""
    top2 = np.sort(probs, axis=1)[:, -2:]
    near = np.flatnonzero(top2[:, 1] - top2[:, 0] < TIE)[:10]
    pred = probs.argmax(axis=1)
    second = np.argsort(probs, axis=1)[:, -2]
    out = []
    for mask in range(2 ** len(near)):
        p = pred.copy()
        for bit, i in enumerate(near):
            if mask >> bit & 1:
                p[i] = second[i]
        out.append(select.weighted_f1(y, p))
    return out


def f1_gap(ref: Reference, cnn: list, host: list, user, test_songs, key,
           got, tf32=False) -> tuple:
    """``(gap, own)``: how far the members' reported F1s on the test split
    (committee order: the CNN members on one crop, or the window grid, of
    each test song, the host members on its frames) lie from the
    reference's, a CNN member's near ties resolved either way; ``own``
    are the F1s of the reference itself (in TF32 with ``tf32``)."""
    y_songs = [user.labels[s] for s in test_songs]
    probs = ref.cnn_probs(cnn, test_songs, key)
    choices = [_f1_choices(y_songs, p) for p in probs]
    idx = [user.songs.index(s) for s in test_songs]
    x = user.frames[idx].reshape(-1, user.frames.shape[-1])
    y = np.repeat(y_songs, user.frames.shape[1])
    dev = ref.inp.data.device
    choices += [[select.weighted_f1(y, ref_host.member_predict(
        st, x, ref.n_class, dev))] for st in host]
    own = ([select.weighted_f1(y_songs, p.argmax(axis=1)) for p in
            ref.cnn_probs(cnn, test_songs, key, True)]
           + [c[0] for c in choices[len(probs):]]) if tf32 else None
    if len(got) != len(choices):
        return select.WRONG, own
    return max(min(abs(g - c) for c in cs)
               for g, cs in zip(got, choices)), own


#: the readings of a broken system that the control runs take besides the
#: TF32 control (``benchmark.faults``): faults of the retrain, from the
#: reference's own trajectory or retrain, and of each host member kind's
#: update, put in the system's place
RETRAIN_FAULTS = ("unchanged_retrain", "fewer_epochs", "last_epoch",
                  "half_batch")
HOST_FAULTS = ("gnb", "sgd", "gbdt")


def compare(inp, cfg: dict, traffic: dict, limits: dict, users: dict,
            snaps: dict, finals: dict, in_window: set, seed: int, *,
            control: bool = False) -> dict:
    """The compared numbers of a run.  ``users``: ``{user_id: (User,
    workspace)}``; ``snaps``: ``{(user_id, epoch): snapshot}`` taken at
    iteration starts; ``finals``: ``{user_id: (epoch, snapshot)}``, a
    finished user's state after its last iteration; ``in_window``: the
    ``(user_id, epoch)`` of the iterations that overlap the window, the
    ones due in it: the sample is drawn from them.  ``control``: also the
    readings of the reference in TF32 put in the system's place
    (``control_<number>``), of the planted faults (``fault_<name>``), and
    each compared retrain member's detail (``retrains``)."""
    ref = Reference(inp, cfg, traffic)
    rng = np.random.default_rng([int(seed), 17])
    q = traffic["queries"]
    runs = {u: reported(path) for u, (_, path) in users.items()}
    picks = {u: {e: q for e, (q, _) in r.items()} for u, r in runs.items()}
    done = sorted(k for k in in_window if k in snaps and k[1] in picks[k[0]])
    pairs = []
    for u, e in done:
        post = snaps.get((u, e + 1))
        if post is None and u in finals and finals[u][0] == e:
            post = finals[u][1]
        if post is not None:
            pairs.append((u, e, post))
    sel = [done[i] for i in sorted(rng.choice(
        len(done), min(len(done), limits["select_checks"]), replace=False))]
    pair_sample = [pairs[i] for i in sorted(rng.choice(
        len(pairs), min(len(pairs), limits["retrain_checks"]),
        replace=False))]
    out = {k: 0.0 for k in NUMBERS}
    #: each output's nearest-epoch readings, one a compared member
    matches = {"system": []}
    if control:
        out.update({f"control_{k}": 0.0 for k in NUMBERS})
        out.update({f"fault_{k}_update": 0.0 for k in HOST_FAULTS})
        matches.update({k: [] for k in ("control",) + RETRAIN_FAULTS})
        out["retrains"] = []

    def worst(name, value):
        out[name] = max(out[name], float(value))

    worst("host_gap", start_gap(ref, rng))
    for u, e in sel:
        user = users[u][0]
        train_songs, _ = ref.split(user)
        live = live_songs(train_songs, picks[u], e)
        key = epoch_keys(user.seed, e)[0]
        cnn = snaps[(u, e)]["cnn"]
        host = _mixed(snaps[(u, e)]["host"],
                      ref.host_states(user, picks[u], e))
        h = ref.entropies(cnn, host, user, live, key)
        pos = {s: i for i, s in enumerate(live)}
        chosen = [pos.get(s, -1) for s in picks[u][e]]
        worst("select_gap", select.selection_gap(h, chosen)
              if len(chosen) == q else select.WRONG)
        if control:
            hc = ref.entropies(cnn, host, user, live, key, tf32=True)
            worst("control_select_gap",
                  select.selection_gap(h, select.top_q(hc, q)))
    eval_sample = [pairs[i] for i in sorted(rng.choice(
        len(pairs), min(len(pairs), limits["f1_checks"]), replace=False))]
    for u, e, post in eval_sample:
        user = users[u][0]
        _, test_songs = ref.split(user)
        key = epoch_keys(user.seed, e)[3]
        host = _mixed(post["host"], ref.host_states(user, picks[u], e + 1))
        gap, own = f1_gap(ref, post["cnn"], host, user, test_songs, key,
                          runs[u][e][1], tf32=control)
        worst("f1_gap", gap)
        if control:
            worst("control_f1_gap", f1_gap(ref, post["cnn"], host, user,
                                           test_songs, key, own)[0])
    for u, e, post in pair_sample:
        user = users[u][0]
        _, test_songs = ref.split(user)
        pre = snaps[(u, e)]
        q_songs = picks[u][e]
        args = (inp.data, ref.lengths, [ref.row[s] for s in q_songs],
                _one_hot([user.labels[s] for s in q_songs], ref.n_class),
                [ref.row[s] for s in test_songs],
                _one_hot([user.labels[s] for s in test_songs], ref.n_class))
        kw = dict(n_epochs=cfg["retrain_epochs"],
                  batch_size=cfg["train"]["batch_size"],
                  lr=cfg["train"]["lr"],
                  weight_decay=cfg["train"]["weight_decay"])
        key = epoch_keys(user.seed, e)[2]
        for i, v in enumerate(pre["cnn"]):
            k_i = prng.fold_in(key, i)
            traj = []
            _, grad = train.fit(v, *args, k_i, ref.tcfg, trajectory=traj,
                                **kw)
            matches["system"].append(
                nearest_epoch(v, post["cnn"][i], traj, grad))
            if control:
                _retrain_readings(out, matches, v, post["cnn"][i], traj,
                                  grad, lambda **f: train.fit(
                                      v, *args, k_i, ref.tcfg, **kw,
                                      **f)[0])
            del traj
        worst("host_gap", host_gap(ref, user, picks[u], e, pre["host"],
                                   post["host"], rng))
        if control:
            for f in HOST_FAULTS:
                worst(f"fault_{f}_update", host_gap(
                    ref, user, picks[u], e, pre["host"], post["host"], rng,
                    fault=f))
    for name, got in matches.items():
        if not got:
            continue
        gap, one = retrain_numbers(got)
        pre = ("" if name == "system" else "control_" if name == "control"
               else f"fault_{name}_")
        out[f"{pre}retrain_gap"], out[f"{pre}retrain_one_epoch"] = gap, one
        if control:
            out["retrains"].append({"output": name, "matches": got})
    out["iterations_compared"] = len(sel)
    out["evaluations_compared"] = len(eval_sample)
    out["retrains_compared"] = len(pair_sample)
    return out


def _retrain_readings(out: dict, matches: dict, pre, post, trajectory,
                      grad, refit) -> None:
    """The control's and the planted retrain faults' nearest-epoch
    readings of one member (into ``matches``), and its detail: each
    epoch's score, and the worst and the median variable's
    :func:`change_gaps` of the system, the control and each fault against
    each epoch of the reference (the starting state first)."""
    keys = loud(grad, list(pre))
    floor = float(np.median(change_gaps(pre, trajectory[-1][1], pre, keys,
                                        1.0)))
    best1 = trajectory[0][1] if trajectory[0][0] > 0 else pre
    outputs = {"system": post, "control": refit(tf32=True),
               "unchanged_retrain": pre, "fewer_epochs": best1,
               "last_epoch": trajectory[-1][1],
               "half_batch": refit(half_batch=True)}
    detail = {"scores": [sc for sc, _ in trajectory]}
    for name, got in outputs.items():
        gaps = [change_gaps(pre, got, st, keys, floor)
                for _, st in [(0.0, pre)] + trajectory]
        detail[name] = [[float(g.max()), float(np.median(g))] for g in gaps]
        if name != "system":
            matches[name].append(nearest_epoch(pre, got, trajectory, grad))
    out["retrains"].append(detail)


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, [(name, value, limit), ...])``: each number at or
    under its limit, and at least one selection, one evaluation and one
    retrain compared."""
    rows = [(k, numbers[k], limits[k]) for k in NUMBERS]
    ok = (all(v <= lim for _, v, lim in rows)
          and numbers["iterations_compared"] > 0
          and numbers["evaluations_compared"] > 0
          and numbers["retrains_compared"] > 0)
    return ok, rows
