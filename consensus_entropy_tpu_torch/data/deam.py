"""DEAM data: the frame-feature and dynamic-annotation join for pre-training.

Counterpart of ``consensus_entropy_tpu/data/deam.py:22-85`` without pandas
(the card machine has none), reproducing ``deam_classifier.py:58-104``:

- ``load_dataset``: the per-song openSMILE CSVs (``;``-separated, 500 ms
  ``frameTime`` steps), sorted by the int of every digit in their path,
  joined with the DEAM dynamic arousal / valence tables (columns
  ``sample_15000ms`` ...).  Each song's annotation row keeps only its
  non-NaN columns (``dropna(axis=1)``, which can drop a middle column, not
  only a NaN tail), the shorter of the two rows names the kept frames, and
  ``frameTime`` must equal ``int(ms) / 1000`` exactly.  Frames take the DEAM
  quadrant geometry's label.  A frame whose column the other annotation
  row dropped raises ``KeyError``, as pandas' ``.loc`` does.
- the cache CSV: a table written by the JAX package (``DataFrame.to_csv``)
  reads here into the same values, and the table written here has the same
  bytes pandas writes (floats as ``repr``, NaN as an empty field).  Floats
  are parsed correctly rounded; pandas' default parser is not, so its
  reading of any cache can part from the table it wrote in the last bit of
  a float64 (never of the float32 training arrays, for the values such
  tables hold).
- ``training_arrays``: the float32 feature slice, scaled as scikit-learn's
  ``StandardScaler`` scales float32 input, ``Q1..Q4`` -> 0..3, song ids;
- ``song_labels`` (``cli/deam_classifier.py:80-84``): each song takes the
  lexicographic max of its frames' quadrants, songs in sorted order
  (``groupby``'s), which fixes the CNN folds.
"""

from __future__ import annotations

import csv
import dataclasses
import io
import os
import re

import numpy as np

from consensus_entropy_tpu_torch.config import feature_slice
from consensus_entropy_tpu_torch.data.amg import _write_cache, standard_scale
from consensus_entropy_tpu_torch.labels import quadrant_deam_np

#: the cells pandas' ``read_csv`` reads as NaN by default
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"})

#: the columns the join appends to the feature files' own
JOIN_COLUMNS = ("arousal", "valence", "quadrants", "song_id")


@dataclasses.dataclass
class DeamTable:
    """The long frame table: ``values[:, j]`` is the feature files' column
    ``columns[j]`` (``frameTime`` among them), then one entry a frame of
    each join column."""

    columns: list
    values: np.ndarray  # (n, len(columns)) float64
    arousal: np.ndarray  # (n,) float64
    valence: np.ndarray  # (n,) float64
    quadrants: np.ndarray  # (n,) str 'Q1'..'Q4'
    song_id: np.ndarray  # (n,) int64

    def __len__(self) -> int:
        return len(self.song_id)

    def equals(self, other: "DeamTable") -> bool:
        """Same columns and the same values, bit for bit (NaN equal)."""
        return (self.columns == other.columns
                and all(np.array_equal(getattr(self, f), getattr(other, f),
                                       equal_nan=f != "quadrants"
                                       and f != "song_id")
                        for f in ("values", "arousal", "valence",
                                  "quadrants", "song_id")))


def _sample_cols_to_seconds(cols) -> list[float]:
    """'sample_15000ms' -> 15.0  (``deam_classifier.py:72``)."""
    return [int(re.sub(r"\D", "", c)) / 1000.0 for c in cols]


def _cells_to_float(rows: list, width: int, path: str) -> np.ndarray:
    """float64 of ragged string rows, pandas' NA cells (and a short row's
    missing tail) as NaN; another non-number raises."""
    out = np.full((len(rows), width), np.nan)
    for i, r in enumerate(rows):
        if len(r) > width:
            raise ValueError(f"{path}: row {i + 1} has {len(r)} fields, the "
                             f"header {width}")
        for j, v in enumerate(r):
            if v not in _NA:
                out[i, j] = float(v)
    return out


def _read_numeric(path: str, sep: str, text: str | None = None):
    """``(header, float64 rows)`` of a CSV of numbers; ``text``: one column
    of ``Q<digit>`` labels, returned as a third item (str array).  Numbers
    parse correctly rounded."""
    with open(path, newline="") as f:
        body = f.read()
    first, _, rest = body.partition("\n")
    header = next(csv.reader([first.rstrip("\r")], delimiter=sep))
    t = header.index(text) if text is not None else None
    if not rest.strip():
        values = np.empty((0, len(header)))
    else:
        try:
            # numpy's C reader: numbers only, every row full
            values = np.loadtxt(
                io.StringIO(rest), delimiter=sep, comments=None, ndmin=2,
                dtype=np.float64,
                converters=None if t is None else {t: _quadrant_code})
        except ValueError:
            # cells pandas reads as NaN (a blank, 'NA', a short row): the
            # same values cell by cell
            rows = list(csv.reader(io.StringIO(rest), delimiter=sep))
            if t is not None:
                labels = np.array([r[t] for r in rows], dtype=str)
                for r in rows:
                    r[t] = ""
            values = _cells_to_float(rows, len(header), path)
            if t is not None:
                return header, values, labels
    if t is None:
        return header, values
    labels = np.array([f"Q{int(c)}" for c in values[:, t]], dtype=str)
    return header, values, labels


def _quadrant_code(cell: str) -> float:
    if len(cell) != 2 or cell[0] != "Q" or not cell[1].isdigit():
        raise ValueError(f"not a quadrant label: {cell!r}")
    return float(cell[1])


def _annotation_rows(path: str) -> tuple[list, np.ndarray, np.ndarray]:
    """``(columns, song ids, float64 values)`` of an annotation table."""
    header, values = _read_numeric(path, ",")
    sid = header.index("song_id")
    return header, values[:, sid].astype(np.int64), values


def _kept_row(columns, ids, values, s_id):
    """The song's annotation row after ``dropna(axis=1)``: ``(names,
    first row's values)`` of the columns no matching row has NaN in, or
    ``None`` when the table has no row for the song."""
    rows = values[ids == s_id]
    if len(rows) == 0:
        return None
    keep = ~np.isnan(rows).any(axis=0)
    names = [c for c, k in zip(columns, keep) if k]
    return names, rows[0, keep]


def _feature_files(features_dir: str) -> list[str]:
    files = []
    for root, _dirs, names in os.walk(features_dir):
        files += [os.path.join(root, f) for f in names
                  if f.lower().endswith(".csv")]
    files.sort(key=lambda f: int(re.sub(r"\D", "", f)))
    if not files:
        raise FileNotFoundError(f"no feature CSVs under {features_dir}")
    return files


def _join(features_dir: str, arousal_csv: str, valence_csv: str
          ) -> DeamTable:
    a_cols, a_ids, a_vals = _annotation_rows(arousal_csv)
    v_cols, v_ids, v_vals = _annotation_rows(valence_csv)
    columns, parts = None, []
    for path in _feature_files(features_dir):
        s_id = int(os.path.basename(path)[: -len(".csv")])
        header, feat = _read_numeric(path, ";")
        if columns is None:
            columns = header
        elif header != columns:
            if sorted(header) != sorted(columns):
                raise ValueError(f"{path}: feature columns differ from the "
                                 "first file's")
            feat = feat[:, [header.index(c) for c in columns]]
        a_row = _kept_row(a_cols, a_ids, a_vals, s_id)
        v_row = _kept_row(v_cols, v_ids, v_vals, s_id)
        if a_row is None or v_row is None:
            continue
        t_a = _sample_cols_to_seconds(a_row[0][1:])
        t_v = _sample_cols_to_seconds(v_row[0][1:])
        # the shorter annotation row wins (deam_classifier.py:75-83)
        t_common = t_a if len(t_a) <= len(t_v) else t_v
        frame_time = feat[:, columns.index("frameTime")]
        sliced = feat[np.isin(frame_time, np.asarray(t_common, np.float64))]
        cols = [f"sample_{int(t * 1000)}ms"
                for t in sliced[:, columns.index("frameTime")]]
        arousal = _values_at(a_row, cols)
        valence = _values_at(v_row, cols)
        parts.append((sliced, arousal, valence,
                      np.full(len(sliced), s_id, np.int64)))
    if not parts:
        raise ValueError("No objects to concatenate: no feature CSV has "
                         "both annotation rows")
    values, arousal, valence, song_id = (np.concatenate(p)
                                         for p in zip(*parts))
    q = quadrant_deam_np(arousal, valence)
    quadrants = np.array([f"Q{c + 1}" for c in q], dtype=str)
    return DeamTable(columns, values.reshape(-1, len(columns)), arousal,
                     valence, quadrants, song_id)


def _values_at(row, cols) -> np.ndarray:
    """``row.loc[:, cols].values[0]``: a name the row lacks raises
    ``KeyError`` as pandas does."""
    names, vals = row
    at = {c: i for i, c in enumerate(names)}
    missing = [c for c in cols if c not in at]
    if missing:
        raise KeyError(f"{missing} not in index")
    return vals[[at[c] for c in cols]].astype(np.float64)


def read_cache(cache_csv: str) -> DeamTable:
    """A cached table, written by this module or by the JAX package."""
    with open(cache_csv, newline="") as f:
        header = next(csv.reader(f))
    if tuple(header[-len(JOIN_COLUMNS):]) != JOIN_COLUMNS:
        raise ValueError(f"{cache_csv}: not a DEAM table (its last columns "
                         f"are not {JOIN_COLUMNS})")
    header, values, quadrants = _read_numeric(cache_csv, ",",
                                              text="quadrants")
    n = len(header) - len(JOIN_COLUMNS)
    return DeamTable(header[:n], np.ascontiguousarray(values[:, :n]),
                     values[:, n], values[:, n + 1], quadrants,
                     values[:, n + 3].astype(np.int64))


def _cache_rows(table: DeamTable):
    """The table's rows as pandas' ``to_csv`` cells: floats as ``repr``,
    NaN empty."""
    nan = (np.isnan(table.values).any(axis=1) | np.isnan(table.arousal)
           | np.isnan(table.valence))
    for row, a, v, q, sid, has_nan in zip(
            table.values.tolist(), table.arousal.tolist(),
            table.valence.tolist(), table.quadrants.tolist(),
            table.song_id.tolist(), nan.tolist()):
        cells = row + [a, v]
        yield ([("" if c != c else repr(c)) for c in cells] if has_nan
               else [*map(repr, cells)]) + [q, str(sid)]


def write_cache(table: DeamTable, cache_csv: str) -> None:
    """The table as ``DataFrame.to_csv(index=False)`` writes it (the same
    bytes), renamed into place: a reader never sees a torn cache."""
    _write_cache(cache_csv, list(table.columns) + list(JOIN_COLUMNS),
                 _cache_rows(table), delimiter=",")


def load_dataset(features_dir: str, arousal_csv: str, valence_csv: str,
                 cache_csv: str | None = None) -> DeamTable:
    """The long frame table (features, arousal, valence, quadrants,
    song_id); read from ``cache_csv`` when it exists, else joined and
    written there."""
    if cache_csv is not None and os.path.exists(cache_csv):
        return read_cache(cache_csv)
    table = _join(features_dir, arousal_csv, valence_csv)
    if cache_csv is not None:
        write_cache(table, cache_csv)
    return table


def training_arrays(table: DeamTable, scale: bool = True):
    """``(X, y, song_ids)`` for the pre-trainer (``deam_classifier.py:
    181-197``): the float32 feature slice, standardized over the pool,
    ``Q1..Q4`` -> 0..3."""
    X = table.values[:, feature_slice(table.columns)].astype(np.float32)
    if scale:
        X = standard_scale(X)
    y = np.array([int(q[1]) - 1 for q in table.quadrants], np.int32)
    return X, y, table.song_id.copy()


def song_labels(table: DeamTable) -> dict:
    """Song id -> class of its lexicographically greatest frame quadrant,
    songs sorted (``df.groupby("song_id")["quadrants"].max()``)."""
    out: dict = {}
    for sid, q in zip(table.song_id.tolist(), table.quadrants.tolist()):
        if sid not in out or q > out[sid]:
            out[sid] = q
    return {sid: int(out[sid][1]) - 1 for sid in sorted(out)}
