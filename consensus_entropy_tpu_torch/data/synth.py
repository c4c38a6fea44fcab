"""The miniature on-disk DEAM + AMG1608 layout, without pandas.

The port's own copy of ``tests/synth_data.py::build_synth_roots``: the same
draws from the same generator in the same order, the same files (the
openSMILE-style ``;`` feature CSVs, the ``sample_{ms}ms`` annotation
tables, the two AMG1608 ``.mat`` files), written with ``csv``-style lines
and ``scipy.io.savemat``.  The CSVs are the bytes ``DataFrame.to_csv``
writes (each float as its shortest round-trip repr); the ``.mat`` files
differ only in savemat's creation-time header.  ``cli.reproduce --smoke``
builds its tree with it, on the card machine too, which has no pandas.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import savemat

FEATURE_COLS = (["F0final_sma_stddev"] + [f"f{i}" for i in range(6)]
                + ["mfcc_sma_de[14]_amean"])


def _cell(v) -> str:
    return repr(float(v))


def _write_csv(path: str, header, rows, sep: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(sep.join(header) + "\n")
        for row in rows:
            f.write(sep.join(row) + "\n")


def _write_features(path: str, times, feats) -> None:
    """One song's openSMILE-style CSV: ``frameTime`` then FEATURE_COLS."""
    _write_csv(path, ["frameTime", *FEATURE_COLS],
               ([_cell(t), *map(_cell, r)] for t, r in zip(times, feats)),
               ";")


def build_synth_roots(root, rng) -> dict:
    """Class-separable synthetic DEAM + AMG1608 trees under ``root`` (24
    DEAM songs of 20 frames, 40 AMG songs of 4-7 frames annotated by 6
    users); returns the ``deam``, ``amg`` and ``models`` paths."""
    root = os.fspath(root)
    centers = rng.standard_normal((4, len(FEATURE_COLS))) * 3.0

    # --- DEAM: features + dynamic annotations -------------------------
    deam = os.path.join(root, "deam")
    os.makedirs(os.path.join(deam, "features"))
    os.makedirs(os.path.join(deam, "annotations"))
    times = np.arange(15.0, 25.0, 0.5)
    cols_ms = [f"sample_{int(t * 1000)}ms" for t in times]
    a_rows, v_rows = [], []
    for sid in range(1, 25):
        target = sid % 4  # song's dominant quadrant
        a_sign = 1.0 if target in (0, 1) else -1.0  # deam geometry
        v_sign = 1.0 if target in (0, 3) else -1.0
        a_vals = a_sign * rng.uniform(0.2, 1.0, len(times))
        v_vals = v_sign * rng.uniform(0.2, 1.0, len(times))
        feats = centers[target] + rng.standard_normal(
            (len(times), len(FEATURE_COLS))).astype(np.float32)
        _write_features(os.path.join(deam, "features", f"{sid}.csv"), times,
                        feats)
        a_rows.append([str(sid), *map(_cell, a_vals)])
        v_rows.append([str(sid), *map(_cell, v_vals)])
    for name, rows in (("arousal", a_rows), ("valence", v_rows)):
        _write_csv(os.path.join(deam, "annotations", f"{name}.csv"),
                   ["song_id", *cols_ms], rows, ",")

    # --- AMG: per-song feature csvs + .mat annotations ----------------
    amg = os.path.join(root, "amg1608")
    os.makedirs(os.path.join(amg, "feats"))
    os.makedirs(os.path.join(amg, "anno"))
    n_songs, n_users = 40, 6
    song_ids = np.arange(201, 201 + n_songs)
    song_class = rng.integers(0, 4, size=n_songs)
    for sid, c in zip(song_ids, song_class):
        k = int(rng.integers(4, 8))
        feats = centers[c] + rng.standard_normal(
            (k, len(FEATURE_COLS))).astype(np.float32)
        _write_features(os.path.join(amg, "feats", f"{sid}.csv"),
                        np.arange(k) * 1.0, feats)
    # annotations: valence/arousal consistent with each song's class (amg
    # geometry, [valence, arousal] order), light per-user noise on magnitude
    lab = np.full((n_songs, n_users, 2), np.nan)
    for i, c in enumerate(song_class):
        a_sign = 1.0 if c in (0, 1) else -1.0
        v_sign = 1.0 if c in (0, 3) else -1.0
        for u in range(n_users):
            if rng.uniform() < 0.9:  # most users annotated most songs
                lab[i, u, 0] = v_sign * rng.uniform(0.3, 1.0)
                lab[i, u, 1] = a_sign * rng.uniform(0.3, 1.0)
    savemat(os.path.join(amg, "anno", "AMG1608.mat"), {"song_label": lab})
    savemat(os.path.join(amg, "anno", "1608_song_id.mat"),
            {"mat_id2song_id": song_ids.reshape(-1, 1)})

    return {"deam": deam, "amg": amg, "models": os.path.join(root, "models")}
