"""The port's DEAM join against the JAX package's, on the CPU.

On a seeded tree with NaN tails, a NaN in the middle of an annotation row,
length mismatches and numbered subdirectories: the frame table and the
training arrays equal JAX's bit for bit; the cache CSV the port writes has
the bytes pandas writes, a JAX-written cache reads here into the JAX
table's values, and JAX reads the port's back into equal arrays; the song
labels equal the CLI's ``groupby().max()`` in value and order; where
pandas raises ``KeyError``, so does the port.  Run under pandas,
scikit-learn and joblib made unimportable, the port's pre-training and
evidence CLIs still run."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.data import deam as jax_deam
from consensus_entropy_tpu_torch.data import deam
from tests.torch_deam_tree import write_deam_tree

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("deam")
    return str(root), write_deam_tree(str(root), np.random.default_rng(7))


def _same_as_jax(table, df):
    """The port's table holds the JAX DataFrame's columns and values."""
    assert table.columns + list(deam.JOIN_COLUMNS) == list(df.columns)
    np.testing.assert_array_equal(table.values,
                                  df[table.columns].to_numpy(np.float64))
    for name in ("arousal", "valence", "song_id"):
        np.testing.assert_array_equal(getattr(table, name),
                                      df[name].to_numpy())
    assert table.quadrants.tolist() == df["quadrants"].tolist()


def test_join_and_training_arrays_equal_jax(tree):
    _, paths = tree
    df = jax_deam.load_dataset(*paths)
    table = deam.load_dataset(*paths)
    assert len(table) == len(df) > 0
    _same_as_jax(table, df)
    # the traps bit: shorter annotation rows and a dropped middle column
    # shorten songs, and the feature files' own short tails too
    counts = np.bincount(table.song_id)
    assert counts[5] == 17 and counts[6] == 19 and counts[7] == 18
    X, y, sids = deam.training_arrays(table)
    jX, jy, jsids = jax_deam.training_arrays(df)
    assert X.dtype == jX.dtype == np.float32
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(sids, jsids)
    np.testing.assert_array_equal(
        deam.training_arrays(table, scale=False)[0],
        jax_deam.training_arrays(df, scale=False)[0])


def test_cache_round_trips_both_ways(tree, tmp_path):
    _, paths = tree
    jax_cache, port_cache = str(tmp_path / "jax.csv"), str(tmp_path / "p.csv")
    df = jax_deam.load_dataset(*paths, cache_csv=jax_cache)
    cold = deam.load_dataset(*paths, cache_csv=port_cache)
    with open(jax_cache, "rb") as a, open(port_cache, "rb") as b:
        assert a.read() == b.read()  # pandas' bytes
    # a JAX-written cache read by the port: the JAX table's values
    from_jax = deam.load_dataset("/nonexistent", "", "", cache_csv=jax_cache)
    assert from_jax.equals(cold)
    _same_as_jax(from_jax, df)
    # the port's warm table, and JAX reading the port's cache
    assert deam.load_dataset(*paths, cache_csv=port_cache).equals(cold)
    jax_warm = jax_deam.load_dataset("/nonexistent", "", "",
                                     cache_csv=port_cache)
    for a, b in zip(jax_deam.training_arrays(jax_warm),
                    deam.training_arrays(cold)):
        np.testing.assert_array_equal(a, b)


def test_song_labels_are_the_clis_groupby_max(tree):
    _, paths = tree
    df = jax_deam.load_dataset(*paths)
    per_song = df.groupby("song_id")["quadrants"].max()
    want = {sid: int(q[1]) - 1 for sid, q in per_song.items()}
    got = deam.song_labels(deam.load_dataset(*paths))
    assert got == want and list(got) == list(want)
    assert len(set(got.values())) > 1


def test_key_error_where_pandas_raises(tmp_path):
    paths = write_deam_tree(str(tmp_path), np.random.default_rng(7),
                            key_error=True)
    with pytest.raises(KeyError):
        jax_deam.load_dataset(*paths)
    with pytest.raises(KeyError, match="sample_17500ms"):
        deam.load_dataset(*paths)


def test_unreadable_cells_and_missing_files(tmp_path):
    with pytest.raises(FileNotFoundError):
        deam.load_dataset(str(tmp_path), "", "")
    bad = tmp_path / "c.csv"
    bad.write_text("a,arousal,valence,quadrants,song_id\n1.0,0.5,0.5,Qx,3\n")
    table = deam.read_cache(str(bad))  # pandas reads it too
    assert table.quadrants.tolist() == ["Qx"]
    with pytest.raises(ValueError):
        deam.training_arrays(table)
    bad.write_text("a,b\n1,2\n")
    with pytest.raises(ValueError, match="not a DEAM table"):
        deam.read_cache(str(bad))


_WITHOUT = """
import sys
for name in ("pandas", "sklearn", "joblib"):
    sys.modules[name] = None
from consensus_entropy_tpu_torch.cli import deam_classifier, evidence
root, out = sys.argv[1], sys.argv[2]
assert deam_classifier.main(["-cv", "2", "-m", "gnb", "--models-root",
                             root + "/models", "--deam-root", root,
                             "--device", "cpu"]) == 0
assert evidence.main(["sweep", "--seeds", "1", "--epochs", "1", "--songs",
                      "60", "--out", out, "--device", "cpu"]) == 0
leaked = [m for m in ("pandas", "sklearn", "joblib") if sys.modules[m]]
assert not leaked, leaked
"""


def test_runs_without_pandas_sklearn_and_joblib(tmp_path):
    write_deam_tree(str(tmp_path), np.random.default_rng(3))
    out = tmp_path / "e.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _WITHOUT, str(tmp_path), str(out)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert {"classifier_gnb.it_0.npz", "classifier_gnb.it_1.npz"} <= set(
        os.listdir(tmp_path / "models" / "pretrained"))
    assert out.exists()
