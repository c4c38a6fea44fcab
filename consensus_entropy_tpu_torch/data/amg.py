"""AMG1608 data: annotations, the human-consensus table, the feature pool.

Counterpart of ``consensus_entropy_tpu/data/amg.py:35-150`` without pandas
(the card machine has none):

- ``load_annotations`` (``amg_test.py:87-126``): the ``song_label`` tensor
  ``(n_songs, n_users, 2)`` ([valence, arousal], NaN = unannotated) joined
  with ``mat_id2song_id`` into columns song_id, user_id, valence, arousal,
  quadrant (AMG geometry), song-major as the JAX table is;
- ``hc_frequency_table`` (``amg_test.py:108-117``): per-song Q1..Q4
  frequencies over all annotators, rounded to 3 decimals;
- ``filter_users`` (``amg_test.py:119-126``): users with >= num_anno
  annotations, in first-appearance order;
- ``load_feature_pool`` (``amg_test.py:57-65,128-144``): the ``;``-separated
  openSMILE frame CSVs (or their cached concatenation), sliced to the 260
  feature columns and standardised over the whole pool, as scikit-learn's
  ``StandardScaler`` does for float32 input; the parsed cache beside the
  CSV cache (the port's own) spares a later read the text parse;
- ``user_pool`` (``amg_test.py:352-356``).
"""

from __future__ import annotations

import csv
import dataclasses
import os
import tempfile
import zipfile

import numpy as np

from consensus_entropy_tpu_torch.config import NUM_CLASSES, feature_slice
from consensus_entropy_tpu_torch.labels import quadrant_amg_np
from consensus_entropy_tpu_torch.models.committee import FramePool


@dataclasses.dataclass
class Annotations:
    """The long annotation table, one row per (song, user) annotation."""

    song_id: np.ndarray
    user_id: np.ndarray
    valence: np.ndarray
    arousal: np.ndarray
    quadrant: np.ndarray

    def take(self, rows) -> "Annotations":
        return Annotations(*(getattr(self, f.name)[rows]
                             for f in dataclasses.fields(self)))


def load_annotations(mat_path: str, mapping_path: str) -> Annotations:
    from scipy.io import loadmat

    anno = loadmat(mat_path)["song_label"]  # (n_songs, n_users, 2)
    mapping = loadmat(mapping_path)["mat_id2song_id"]
    n_songs, n_users = anno.shape[0], anno.shape[1]
    song_ids = np.repeat(np.asarray(mapping).reshape(n_songs)[:, None],
                         n_users, axis=1).ravel()
    user_ids = np.tile(np.arange(n_users), n_songs)
    valence = anno[:, :, 0].ravel()
    arousal = anno[:, :, 1].ravel()
    ok = ~(np.isnan(valence) | np.isnan(arousal))
    return Annotations(song_ids[ok], user_ids[ok], valence[ok], arousal[ok],
                       quadrant_amg_np(arousal[ok], valence[ok]))


@dataclasses.dataclass
class HCTable:
    """Per-song quadrant frequencies: ``freq[i]`` is song ``song_ids[i]``'s
    Q1..Q4 row (songs sorted)."""

    song_ids: np.ndarray
    freq: np.ndarray

    def rows_for(self, song_ids) -> np.ndarray:
        """float32 rows of ``song_ids`` in that order, NaN for a song the
        table lacks (``DataFrame.reindex``)."""
        index = {s: i for i, s in enumerate(self.song_ids.tolist())}
        out = np.full((len(song_ids), NUM_CLASSES), np.nan, np.float32)
        for j, s in enumerate(song_ids):
            i = index.get(s)
            if i is not None:
                out[j] = self.freq[i]
        return out


def hc_frequency_table(anno: Annotations) -> HCTable:
    songs, inv = np.unique(anno.song_id, return_inverse=True)
    counts = np.zeros((len(songs), NUM_CLASSES), np.int64)
    np.add.at(counts, (inv, anno.quadrant), 1)
    freq = counts / counts.sum(axis=1, keepdims=True)
    return HCTable(songs, np.round(freq, 3))


def filter_users(anno: Annotations, num_anno: int):
    """``(filtered annotations, user ids)``, users in first-appearance
    order."""
    users, counts = np.unique(anno.user_id, return_counts=True)
    keep = users[counts >= num_anno]
    out = anno.take(np.isin(anno.user_id, keep))
    users, first = np.unique(out.user_id, return_index=True)
    return out, [u.item() for u in users[np.argsort(first)]]


def _song_id(value: str):
    """An ``s_id`` cell as pandas types it: an int where it is one."""
    try:
        return int(value)
    except ValueError:
        return value


def _read_table(path: str) -> tuple[list[str], list[list[str]]]:
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter=";"))
    if not rows:
        raise ValueError(f"{path}: empty CSV")
    return rows[0], rows[1:]


def _assemble_feature_csvs(features_dir: str):
    """Concatenate the per-song openSMILE CSVs ``{song_id}.csv`` (walk
    order, files sorted), drop ``frameTime``, tag rows with ``s_id`` as
    the last column (numeric ids as ints, ``amg_test.py:128-144``)."""
    header, rows = None, []
    for root, _dirs, files in os.walk(features_dir):
        for fname in sorted(files):
            if not fname.lower().endswith(".csv"):
                continue
            cols, body = _read_table(os.path.join(root, fname))
            sid = fname[: -len(".csv")]
            keep = [i for i, c in enumerate(cols) if c != "frameTime"]
            names = [cols[i] for i in keep]
            if header is None:
                header = names
            elif names != header:
                order = [names.index(c) for c in header]
                keep = [keep[i] for i in order]
            tag = sid if not sid.isdigit() else str(int(sid))
            rows.extend([r[i] for i in keep] + [tag] for r in body)
    if header is None:
        raise FileNotFoundError(f"no feature CSVs under {features_dir}")
    return header + ["s_id"], rows


def _write_cache(dataset_csv: str, header, rows, delimiter: str = ";"
                 ) -> None:
    """Write the concatenated table atomically: a reader never sees a torn
    cache, and concurrent writers produce the same bytes."""
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(dataset_csv)), suffix=".tmp")
    try:
        with os.fdopen(fd, "w", newline="") as f:
            w = csv.writer(f, delimiter=delimiter, lineterminator="\n")
            w.writerow(header)
            w.writerows(rows)
        os.replace(tmp, dataset_csv)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def standard_scale(X: np.ndarray) -> np.ndarray:
    """``StandardScaler().fit_transform(X)`` for float32 ``X``: the mean
    and the corrected two-pass variance summed in float64
    (``_incremental_mean_and_var`` from a zero count), near-constant
    columns scaled by 1 (``_is_constant_feature``), then ``X -= mean;
    X /= scale`` in float32, the parameters cast to float32 first."""
    X = np.array(X, np.float32)
    count = np.full(X.shape[1], float(X.shape[0]))
    total = np.sum(X, axis=0, dtype=np.float64)
    mean = total / count
    temp = X - mean
    correction = np.sum(temp, axis=0)
    temp **= 2
    var = np.sum(temp, axis=0)
    var -= correction ** 2 / count
    var = var / count
    eps = np.finfo(np.float64).eps
    constant = var <= count * eps * var + (count * mean * eps) ** 2
    scale = np.sqrt(var)
    scale[constant] = 1.0
    X -= mean.astype(np.float32)
    X /= scale.astype(np.float32)
    return X


#: the parsed cache beside a CSV cache ``P``: ``P`` + this suffix
PARSED_SUFFIX = ".parsed.npz"


def _csv_key(dataset_csv: str) -> np.ndarray:
    """What names one version of the CSV cache: its size, modification
    time and inode (a rewrite is a new file, ``_write_cache``)."""
    st = os.stat(dataset_csv)
    return np.array([st.st_size, st.st_mtime_ns, st.st_ino], np.int64)


def _read_parsed(dataset_csv: str):
    """``(X, s_id cells)`` from the parsed cache when it was made from the
    CSV cache as it is now, else None (missing, stale or unreadable)."""
    try:
        key = _csv_key(dataset_csv)
        with np.load(dataset_csv + PARSED_SUFFIX) as z:
            if not np.array_equal(z["key"], key):
                return None
            return z["X"], z["sid"].tolist()
    except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
        return None


def _write_parsed(dataset_csv: str, key, X: np.ndarray, sids) -> None:
    """Write the parsed cache atomically; a directory that refuses it
    leaves the CSV cache the only one."""
    try:
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(dataset_csv)),
            suffix=".tmp")
    except OSError:
        return
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, key=key, X=X, sid=np.array(sids, dtype=str))
        os.replace(tmp, dataset_csv + PARSED_SUFFIX)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def load_feature_pool(dataset_csv: str | None = None,
                      features_dir: str | None = None,
                      scale: bool = True) -> FramePool:
    """The scaled frame-feature pool.  Reads the cached table if present,
    else assembles the per-song CSVs and writes the cache; the table's
    parse is kept beside the cache, keyed by the cache's version."""
    parsed = None
    if dataset_csv is not None and os.path.exists(dataset_csv):
        parsed = _read_parsed(dataset_csv)
        if parsed is None:
            key = _csv_key(dataset_csv)
            header, rows = _read_table(dataset_csv)
    else:
        header, rows = _assemble_feature_csvs(features_dir)
        if dataset_csv is not None:
            _write_cache(dataset_csv, header, rows)
            key = _csv_key(dataset_csv)
    if parsed is None:
        cols = feature_slice(header)
        sid_col = header.index("s_id")
        X = np.array([[float(v) for v in r[cols]] for r in rows],
                     np.float64).astype(np.float32)
        sids = [r[sid_col] for r in rows]
        if dataset_csv is not None:
            _write_parsed(dataset_csv, key, X, sids)
    else:
        X, sids = parsed
    if scale:
        X = standard_scale(X)
    return FramePool(X, [_song_id(s) for s in sids])


def user_pool(pool: FramePool, anno: Annotations, user_id) -> tuple:
    """The pool restricted to one user's annotated songs and that user's
    labels ``{song: class}``."""
    mine = anno.take(anno.user_id == user_id)
    labels = dict(zip(mine.song_id.tolist(), mine.quadrant.tolist()))
    songs = [s for s in pool.song_ids if s in labels]
    rows = pool.rows_for_songs(songs)
    frame_song = np.concatenate([[s] * pool.count_of(s) for s in songs])
    sub = FramePool(pool.X[rows], frame_song)
    return sub, {s: int(labels[s]) for s in songs}
