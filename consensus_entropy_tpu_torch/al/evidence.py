"""Statistical evidence that consensus-entropy acquisition beats random.

Counterpart of ``consensus_entropy_tpu/al/evidence.py:1-521`` (whose notes
explain the experiment's design): the paper's analysis of the AL runs,
per-user final F1 compared across acquisition modes with paired one-sided
t-tests (paper section 4.1: MC > RAND, p = 0.0291, d.f. 229; ``rand`` is
the control, ``amg_test.py:486-489``).

- :func:`sweep`: per seed, one synthetic user (pool, labels, hc table and,
  for CNN committees, tone waveforms) and one weak pretrained committee,
  run through the production ``ALLoop`` once per mode at a matched budget.
  The draws are numpy's, so pools, labels, hc rows and waveforms equal the
  JAX package's; CNN fold members draw their initial variables and
  training under ``prng`` keys, as the JAX ones do under ``jax.random``.
- :func:`analyze_users`: the same paired analysis over the AL CLI's
  ``{uid}/{mode}/metrics.jsonl`` files.

Pairing follows the paper: (user or seed, member) final-F1 pairs between
modes, plus a stricter per-seed committee-mean pairing.  Every entry point
takes ``device=`` and runs the committee's device work there.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from consensus_entropy_tpu_torch.al.loop import ALLoop, UserData
from consensus_entropy_tpu_torch.config import ALConfig, CNNConfig, TrainConfig
from consensus_entropy_tpu_torch.device import resolve_device
from consensus_entropy_tpu_torch.models.committee import Committee, FramePool
from consensus_entropy_tpu_torch.models.members import GNBMember, SGDMember

MODES = ("mc", "hc", "mix", "rand")

#: the tiny CNN of the --cnn-members committees; pretraining runs hot (lr
#: 1e-3), retraining in the AL loop at the reference's 1e-4
CNN_CFG = CNNConfig(n_channels=4, n_fft=256, hop_length=128, n_mels=16,
                    n_layers=3, input_length=2048)
CNN_PRETRAIN = TrainConfig(batch_size=4, lr=1e-3)
CNN_RETRAIN = TrainConfig(batch_size=4)  # reference lr=1e-4

#: per-class tone frequencies of the synthetic waveforms: the confusable
#: pair (classes 2/3) one semitone apart
TONE_FREQS = (220.0, 440.0, 784.0, 831.0)

#: the unfamiliar songs' class -> frequency mapping of the full-geometry
#: pools (the same confusable-pair structure, other f0s)
USER_FREQS = (311.1, 587.3, 987.8, 1046.5)

#: class priors: the confusable pair is rare
CLASS_P = (0.35, 0.35, 0.15, 0.15)

#: pretrain songs per class: the rare pair is barely pretrained
PRETRAIN_SONGS = {0: 3, 1: 3, 2: 1, 3: 1}


def synth_tone(class_c: int, n: int, rng: np.random.Generator, *,
               sample_rate: float, timbre: str = "sine",
               noise: float = 0.3, freqs=TONE_FREQS) -> np.ndarray:
    """A detuned class tone in one of two timbres plus white noise."""
    t = np.arange(n) / sample_rate
    f = freqs[class_c] * (1.0 + 0.01 * rng.standard_normal())
    tone = np.sin(2 * np.pi * f * t)
    if timbre == "square":
        tone = np.sign(tone) * 0.8
    elif timbre != "sine":
        raise ValueError(f"unknown timbre {timbre!r}")
    amp = float(rng.uniform(0.8, 1.2))
    return (amp * tone
            + noise * rng.standard_normal(n)).astype(np.float32)


def familiar_timbre(song_id: str) -> bool:
    """Even-index songs carry the pretraining corpus's timbre (sine)."""
    return int(song_id[4:]) % 2 == 0


def make_user(seed: int, *, n_songs: int = 250, n_feat: int = 12,
              sep: float = 3.0, hard_delta: float = 0.9,
              easy_delta: float | None = None, off: float = 0.5,
              noise: float = 0.7, tau: float = 1.0,
              waves: bool = False,
              cnn_cfg: CNNConfig = CNN_CFG,
              unfamiliar_freqs=None, device=None) -> UserData:
    """One synthetic user: two easy, abundant classes and a rare
    confusable pair (class 3's center ``hard_delta`` from class 2's;
    ``easy_delta`` places class 1's that far from class 0's), an hc table
    of softmax proximities rounded to 3 decimals, and with ``waves`` a
    waveform store on ``device`` (sines for even songs, square waves for
    odd ones; ``unfamiliar_freqs`` shifts the odd songs' tones)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4, n_feat)).astype(np.float32) * sep
    if easy_delta is not None:
        d01 = rng.standard_normal(n_feat).astype(np.float32)
        centers[1] = centers[0] + d01 * (easy_delta / np.linalg.norm(d01))
    d = rng.standard_normal(n_feat).astype(np.float32)
    centers[3] = centers[2] + d * (hard_delta / np.linalg.norm(d))
    rows, sids, labels = [], [], {}
    hc = np.empty((n_songs, 4), np.float32)
    classes = rng.choice(4, size=n_songs, p=CLASS_P)
    for i, c in enumerate(classes):
        sid = f"song{i:04d}"
        labels[sid] = int(c)
        k = int(rng.integers(3, 7))
        song_mean = centers[c] + rng.standard_normal(n_feat).astype(
            np.float32) * off
        rows.append(song_mean + rng.standard_normal(
            (k, n_feat)).astype(np.float32) * noise)
        sids += [sid] * k
        d2 = np.sum((centers - song_mean) ** 2, axis=1)
        p = np.exp(-(d2 - d2.min()) / (2 * tau * n_feat))
        hc[i] = np.round(p / p.sum(), 3)
    pool = FramePool(np.vstack(rows), sids)
    order = {s: j for j, s in enumerate(f"song{i:04d}"
                                        for i in range(n_songs))}
    hc = hc[[order[s] for s in pool.song_ids]]
    store = None
    if waves:
        from consensus_entropy_tpu_torch.data.audio import DeviceWaveformStore

        wave_dict = {}
        for i, c in enumerate(classes):
            n = cnn_cfg.input_length + int(rng.integers(200, 1200))
            fam = familiar_timbre(f"song{i:04d}")
            wave_dict[f"song{i:04d}"] = synth_tone(
                c, n, rng, sample_rate=cnn_cfg.sample_rate,
                timbre=("sine" if fam else "square"),
                freqs=(TONE_FREQS if fam or unfamiliar_freqs is None
                       else unfamiliar_freqs))
        store = DeviceWaveformStore(wave_dict, cnn_cfg.input_length, device)
    return UserData(f"seed{seed}", pool, labels, hc_rows=hc, store=store)


def make_committee(seed: int, data: UserData, *, folds: int = 5,
                   cnn_members: int = 0, cnn_pretrain_epochs: int = 10,
                   cnn_pretrain_songs: int | None = None,
                   sgd_members: int = 0,
                   cnn_registry: str | None = None,
                   cnn_cfg: CNNConfig = CNN_CFG,
                   cnn_retrain: TrainConfig = CNN_RETRAIN,
                   device=None) -> Committee:
    """``folds`` GaussianNB members, each fitted on its own random song
    subset (``PRETRAIN_SONGS`` a class), drawn without looking at the AL
    split; ``sgd_members`` SGD members on the same slices; CNN members
    from ``cnn_registry``'s ``classifier_cnn.it_{f}.npz``, or
    ``cnn_members`` tiny ones pretrained on their fold's familiar-timbre
    songs under ``prng.key(seed*131+f)`` / ``prng.key(seed*7+f)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed + 10_000)
    by_class: dict[int, list] = {c: [] for c in range(4)}
    for s, c in data.labels.items():
        by_class[c].append(s)
    members = []
    fold_songs = []
    for f in range(folds):
        X, y = [], []
        picked = []
        for c, songs in by_class.items():
            for s in rng.permutation(songs)[:PRETRAIN_SONGS[c]]:
                rows = data.pool.rows_for_songs([s])
                X.append(data.pool.X[rows])
                y += [c] * len(rows)
                picked.append(s)
        fold_songs.append(picked)
        members.append(
            GNBMember(name=f"gnb{f}").fit(np.vstack(X), np.asarray(y)))
    for f in range(sgd_members):
        sl = fold_songs[f % folds]
        rows = np.concatenate([data.pool.rows_for_songs([s]) for s in sl])
        y = np.concatenate([[data.labels[s]] * data.pool.count_of(s)
                            for s in sl])
        members.append(SGDMember(name=f"sgd{f}", seed=seed * 31 + f).fit(
            data.pool.X[rows], y))
    cnns = []
    if cnn_registry is not None:
        from consensus_entropy_tpu_torch.models.committee import CNNMember

        for f in range(cnn_members or 5):
            path = os.path.join(cnn_registry, f"classifier_cnn.it_{f}.npz")
            m = CNNMember.load(path, cnn_cfg, dev)
            m.name = f"cnn{f}"
            cnns.append(m)
        return Committee(members, cnns, cnn_cfg, cnn_retrain, device=dev)
    if cnn_members:
        from consensus_entropy_tpu_torch import prng
        from consensus_entropy_tpu_torch.labels import one_hot_np
        from consensus_entropy_tpu_torch.models import short_cnn
        from consensus_entropy_tpu_torch.models.cnn_trainer import CNNTrainer
        from consensus_entropy_tpu_torch.models.committee import CNNMember

        trainer = CNNTrainer(cnn_cfg, CNN_PRETRAIN)
        # CNN folds pretrain on the familiar timbre only
        by_class = {c: [s for s in pool_c if familiar_timbre(s)]
                    for c, pool_c in by_class.items()}
        for f in range(cnn_members):
            songs = fold_songs[f % folds]
            if cnn_pretrain_songs:
                # a deeper sample at the GNB folds' 3:1 class asymmetry
                rng_f = np.random.default_rng(seed * 977 + f)
                songs = [
                    s for c, pool_c in by_class.items()
                    for s in rng_f.permutation(pool_c)[
                        :max(1, round(cnn_pretrain_songs
                                      * PRETRAIN_SONGS[c] / 3))]]
            y1 = one_hot_np([data.labels[s] for s in songs])
            variables = short_cnn.init_variables(
                prng.key(seed * 131 + f, dev), cnn_cfg, dev)
            best, _ = trainer.fit(variables, data.store, songs, y1, songs,
                                  y1, prng.key(seed * 7 + f, dev),
                                  n_epochs=cnn_pretrain_epochs)
            cnns.append(CNNMember(f"cnn{f}", best, cnn_cfg))
    return Committee(members, cnns, cnn_cfg, cnn_retrain, device=dev)


def run_one(seed: int, mode: str, workdir: str, *, queries: int = 5,
            epochs: int = 8, n_songs: int = 250, cnn_members: int = 0,
            cnn_pretrain_epochs: int = 10, cnn_retrain_epochs: int = 5,
            cnn_pretrain_songs: int | None = None,
            easy_delta: float | None = None,
            hard_delta: float = 0.9, sgd_members: int = 0,
            cnn_registry: str | None = None,
            cnn_cfg: CNNConfig = CNN_CFG,
            cnn_retrain: TrainConfig = CNN_RETRAIN,
            unfamiliar_freqs=None,
            gate_host_updates: bool = False,
            device=None) -> list[list[float]]:
    """One (seed, mode) AL run through the production loop into
    ``{workdir}/seed{seed}/{mode}``; returns the per-epoch per-member F1
    lists of its ``metrics.jsonl`` (the epoch-0 baseline included)."""
    dev = resolve_device(device)
    has_cnns = bool(cnn_members) or cnn_registry is not None
    data = make_user(seed, n_songs=n_songs, waves=has_cnns,
                     easy_delta=easy_delta, hard_delta=hard_delta,
                     cnn_cfg=cnn_cfg, unfamiliar_freqs=unfamiliar_freqs,
                     device=dev)
    committee = make_committee(seed, data, cnn_members=cnn_members,
                               cnn_pretrain_epochs=cnn_pretrain_epochs,
                               cnn_pretrain_songs=cnn_pretrain_songs,
                               sgd_members=sgd_members,
                               cnn_registry=cnn_registry, cnn_cfg=cnn_cfg,
                               cnn_retrain=cnn_retrain, device=dev)
    path = os.path.join(workdir, f"seed{seed}", mode)
    os.makedirs(path, exist_ok=True)
    metrics = os.path.join(path, "metrics.jsonl")
    if os.path.exists(metrics):
        # the report appends: a previous sweep's records would corrupt
        # the statistics
        os.unlink(metrics)
    cfg = ALConfig(queries=queries, epochs=epochs, mode=mode, seed=seed,
                   gate_host_updates=gate_host_updates)
    ALLoop(cfg, retrain_epochs=(cnn_retrain_epochs if has_cnns else None),
           device=dev).run_user(committee, data, path, resume=False)
    with open(metrics) as fh:
        return [json.loads(line)["f1"] for line in fh]


def sweep(seeds: Sequence[int], workdir: str, *, modes=MODES,
          queries: int = 5, epochs: int = 8, n_songs: int = 250,
          cnn_members: int = 0, cnn_pretrain_epochs: int = 10,
          cnn_retrain_epochs: int = 5, cnn_pretrain_songs: int | None = None,
          easy_delta: float | None = None, hard_delta: float = 0.9,
          sgd_members: int = 0, cnn_registry: str | None = None,
          cnn_cfg: CNNConfig = CNN_CFG,
          cnn_retrain: TrainConfig = CNN_RETRAIN,
          unfamiliar_freqs=None, gate_host_updates: bool = False,
          log=print, device=None) -> dict:
    """Matched-budget mode sweep: every mode sees the same user, committee
    state, split and query budget a seed.  Returns ``{mode: {seed:
    [[member f1 per epoch]]}}``."""
    results: dict = {m: {} for m in modes}
    for seed in seeds:
        for mode in modes:
            results[mode][seed] = run_one(
                seed, mode, workdir, queries=queries, epochs=epochs,
                n_songs=n_songs, cnn_members=cnn_members,
                cnn_pretrain_epochs=cnn_pretrain_epochs,
                cnn_retrain_epochs=cnn_retrain_epochs,
                cnn_pretrain_songs=cnn_pretrain_songs,
                easy_delta=easy_delta, hard_delta=hard_delta,
                sgd_members=sgd_members, cnn_registry=cnn_registry,
                cnn_cfg=cnn_cfg, cnn_retrain=cnn_retrain,
                unfamiliar_freqs=unfamiliar_freqs,
                gate_host_updates=gate_host_updates, device=device)
            final = float(np.mean(results[mode][seed][-1]))
            log(f"  seed {seed} {mode:4s}: final mean F1 = {final:.4f}")
    return results


def _paired_one_sided(a: np.ndarray, b: np.ndarray) -> dict:
    """One-sided paired t-test for mean(a) > mean(b) (paper section 4.1)."""
    from scipy.stats import ttest_rel

    t = ttest_rel(a, b, alternative="greater")
    return {"t": float(t.statistic), "p": float(t.pvalue),
            "df": int(len(a) - 1),
            "mean_diff": float(np.mean(np.asarray(a) - np.asarray(b)))}


def paired_tests(results: dict, *, baseline: str = "rand") -> dict:
    """Mode-vs-baseline tests on final F1: (seed, member) pairs (the
    paper's d.f. structure), committee-mean pairs a seed, and the per-seed
    pairing on the trajectory AUC (mean F1 over epochs)."""
    out = {}
    base = results[baseline]
    seeds = sorted(base)
    for mode, by_seed in results.items():
        if mode == baseline:
            continue
        a_m = np.concatenate([by_seed[s][-1] for s in seeds])
        b_m = np.concatenate([base[s][-1] for s in seeds])
        a_s = np.array([np.mean(by_seed[s][-1]) for s in seeds])
        b_s = np.array([np.mean(base[s][-1]) for s in seeds])
        a_auc = np.array([np.mean([np.mean(e) for e in by_seed[s]])
                          for s in seeds])
        b_auc = np.array([np.mean([np.mean(e) for e in base[s]])
                          for s in seeds])
        out[f"{mode}>{baseline}"] = {
            "per_member_final": _paired_one_sided(a_m, b_m),
            "per_seed_final": _paired_one_sided(a_s, b_s),
            "per_seed_auc": _paired_one_sided(a_auc, b_auc),
        }
    return out


def species_tests(results: dict, slices: dict[str, slice], *,
                  baseline: str = "rand") -> dict:
    """The per-member paired finals of one member species at a time
    (committee order: CNN members first, then the host members)."""
    out: dict = {}
    base = results[baseline]
    seeds = sorted(base)
    for name, sl in slices.items():
        for mode, by_seed in results.items():
            if mode == baseline:
                continue
            a = np.concatenate([np.asarray(by_seed[s][-1])[sl]
                                for s in seeds])
            b = np.concatenate([np.asarray(base[s][-1])[sl] for s in seeds])
            out[f"{name}:{mode}>{baseline}"] = _paired_one_sided(a, b)
    return out


def trajectories(results: dict) -> dict:
    """Mode -> mean trajectory (committee-mean F1 a epoch over seeds)."""
    out = {}
    for mode, by_seed in results.items():
        trajs = [[float(np.mean(e)) for e in per_epoch]
                 for per_epoch in by_seed.values()]
        n = min(map(len, trajs))
        arr = np.array([t[:n] for t in trajs])
        out[mode] = {"mean": arr.mean(axis=0).round(4).tolist(),
                     "std": arr.std(axis=0).round(4).tolist()}
    return out


def analyze_users(users_root: str, *, modes=MODES,
                  baseline: str = "rand") -> dict:
    """The paired analysis over real runs: reads ``{users_root}/{uid}/
    {mode}/metrics.jsonl`` (the AL CLI's layout), pairs the users present
    in both modes, and runs the per-(user, member) one-sided t-tests."""
    per_mode: dict = {m: {} for m in modes}
    for uid in sorted(os.listdir(users_root)):
        for mode in modes:
            p = os.path.join(users_root, uid, mode, "metrics.jsonl")
            if not os.path.exists(p):
                continue
            with open(p) as fh:
                lines = [json.loads(x) for x in fh]
            if lines:
                per_mode[mode][uid] = [rec["f1"] for rec in lines]
    present = {m: set(d) for m, d in per_mode.items()}
    out = {"n_users": {m: len(d) for m, d in per_mode.items()}, "tests": {}}
    for mode in modes:
        if mode == baseline or not per_mode[mode]:
            continue
        shared = sorted(present[mode] & present.get(baseline, set()))
        if not shared:
            continue
        # pairing must hold user by user: offsetting mismatches would
        # misalign every pair after the first bad user
        unpaired = [u for u in shared
                    if len(per_mode[mode][u][-1])
                    != len(per_mode[baseline][u][-1])]
        if unpaired:
            out["tests"][f"{mode}>{baseline}"] = {
                "skipped": "unpaired member counts for users "
                           f"{unpaired}: runs used different committee "
                           "sizes"}
            continue
        a = np.concatenate([per_mode[mode][u][-1] for u in shared])
        b = np.concatenate([per_mode[baseline][u][-1] for u in shared])
        out["tests"][f"{mode}>{baseline}"] = {
            "n_users_paired": len(shared),
            "per_member_final": _paired_one_sided(a, b)}
    return out
