"""A seeded DEAM tree with the traps of the real one, for the port's DEAM
tests: per-song ``;``-separated feature CSVs (500 ms ``frameTime`` steps
from 15 s) in numbered subdirectories, and ``arousal.csv`` /
``valence.csv`` with ``sample_{ms}ms`` columns whose rows carry NaN tails,
a NaN in the middle of a row and length mismatches.  Written with the csv
module, so the port's tests can run it where pandas is absent."""

import csv
import os

import numpy as np

#: the openSMILE slice's first and last columns around a few others
FEATURE_COLS = (["F0final_sma_stddev"] + [f"f{i}" for i in range(6)]
                + ["mfcc_sma_de[14]_amean"])


def write_deam_tree(root, rng, *, n_songs=24, n_frames=20, key_error=False):
    """``{root}/features/{2013|2014}/{sid}.csv`` and
    ``{root}/annotations/{arousal,valence}.csv``; returns the three paths
    ``load_dataset`` takes.  Songs are class-separable by their annotation
    quadrant.  ``key_error``: one song's arousal row drops a middle column
    that its shorter valence row still names (pandas raises ``KeyError``)."""
    feats = os.path.join(root, "features")
    anno = os.path.join(root, "annotations")
    os.makedirs(anno, exist_ok=True)
    times = 15.0 + 0.5 * np.arange(n_frames)
    cols_ms = [f"sample_{int(t * 1000)}ms" for t in times]
    centers = rng.standard_normal((4, len(FEATURE_COLS))) * 3.0
    a_rows, v_rows = [], []
    for sid in range(1, n_songs + 1):
        target = sid % 4
        a_sign = 1.0 if target in (0, 1) else -1.0  # DEAM geometry
        v_sign = 1.0 if target in (0, 3) else -1.0
        # 4-decimal values, as the real tables print them
        a = np.round(a_sign * rng.uniform(0.05, 1.0, n_frames), 4)
        v = np.round(v_sign * rng.uniform(0.05, 1.0, n_frames), 4)
        a[rng.random(n_frames) < 0.1] *= -1  # a few frames cross an axis
        n_feat_rows = n_frames - (sid % 3)  # fewer frames than annotations
        if sid % 5 == 0:
            a[-3:] = np.nan  # NaN tail: arousal shorter
        if sid % 7 == 0:
            v[-2:] = np.nan  # valence shorter
        if sid == 6:
            a[4] = np.nan  # a middle column: dropna(axis=1) drops it
        if key_error and sid == 9:
            a[5] = np.nan
            v[-2:] = np.nan  # the shorter valence row names column 5
        sub = os.path.join(feats, "2013" if sid % 2 else "2014")
        os.makedirs(sub, exist_ok=True)
        x = (centers[target] + rng.standard_normal(
            (n_feat_rows, len(FEATURE_COLS)))).astype(np.float32)
        with open(os.path.join(sub, f"{sid}.csv"), "w", newline="") as f:
            w = csv.writer(f, delimiter=";", lineterminator="\n")
            w.writerow(["frameTime"] + FEATURE_COLS)
            for t, row in zip(times, x):
                # float32's shortest digits (openSMILE prints few), which
                # pandas' parser reads correctly rounded
                w.writerow([repr(float(t))] + [str(v_) for v_ in row])
        a_rows.append([sid] + list(a))
        v_rows.append([sid] + list(v))
    paths = []
    for name, rows in (("arousal", a_rows), ("valence", v_rows)):
        path = os.path.join(anno, f"{name}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["song_id"] + cols_ms)
            for r in rows:
                w.writerow([r[0]] + ["" if np.isnan(x) else repr(float(x))
                                     for x in r[1:]])
        paths.append(path)
    return feats, paths[0], paths[1]


def write_deam_npy(root, song_ids, n_samples, rng):
    """One seeded ``{sid}.npy`` waveform a song under ``{root}/npy``."""
    npy = os.path.join(root, "npy")
    os.makedirs(npy, exist_ok=True)
    for sid in song_ids:
        np.save(os.path.join(npy, f"{sid}.npy"),
                rng.standard_normal(n_samples).astype(np.float32))
    return npy
