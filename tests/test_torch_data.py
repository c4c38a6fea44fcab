"""The port's labels and AMG1608 loaders (no pandas) against the JAX
package's (pandas) on ``tests/synth_data.py`` trees, on the CPU.

Every comparison is exact: quadrants, annotations, the rounded hc table,
user order, the feature pool's song ids and its standardised float32
frames (the port parses the CSVs with Python's float, pandas with its own
parser; after the float32 cast they agree bit for bit here), from the
per-song CSVs and from either package's cache, in both openSMILE column
vintages."""

import os

import numpy as np
import pytest
import torch

from consensus_entropy_tpu import labels as jax_labels
from consensus_entropy_tpu.config import feature_slice as jax_feature_slice
from consensus_entropy_tpu.data import amg as jax_amg
from consensus_entropy_tpu_torch import labels
from consensus_entropy_tpu_torch.config import (
    FEATURE_SLICE_START,
    FEATURE_SLICE_STOP,
    feature_slice,
)
from consensus_entropy_tpu_torch.data import amg
from tests.synth_data import FEATURE_COLS_FFTMAG, amg_dataset_frame
from tests.synth_data import build_synth_roots

torch.set_num_threads(1)


def test_quadrants_and_codecs_match():
    axis = np.array([-1.0, -0.0, 0.0, 0.5])
    a, v = (g.ravel() for g in np.meshgrid(axis, axis))
    for ours, theirs in ((labels.quadrant_amg_np, jax_labels.quadrant_amg_np),
                         (labels.quadrant_deam_np,
                          jax_labels.quadrant_deam_np)):
        np.testing.assert_array_equal(ours(a, v), theirs(a, v))
        assert ours(a, v).dtype == np.int32
    names = ["Q3", "Q1", "Q4", "Q2"]
    np.testing.assert_array_equal(labels.names_to_classes(names),
                                  jax_labels.names_to_classes(names))
    assert [labels.class_to_name(c) for c in range(4)] == \
        [jax_labels.class_to_name(c) for c in range(4)]
    np.testing.assert_array_equal(labels.one_hot_np([2, 0, 3]),
                                  jax_labels.one_hot_np([2, 0, 3]))


def test_feature_slice_on_column_names():
    cols = ["frameTime", FEATURE_SLICE_START, "a", "b", FEATURE_SLICE_STOP,
            "s_id"]
    assert cols[feature_slice(cols)] == cols[1:5]
    df = amg_dataset_frame(np.random.default_rng(0), n_songs=3,
                           feature_cols=FEATURE_COLS_FFTMAG)
    cols = list(df.columns)
    assert cols[feature_slice(cols)] == list(jax_feature_slice(df).columns)
    with pytest.raises(ValueError, match="unrecognized"):
        feature_slice(["x", "y"])


@pytest.fixture
def roots(tmp_path, rng):
    return build_synth_roots(tmp_path, rng)


def _paths(root):
    return (os.path.join(root, "anno", "AMG1608.mat"),
            os.path.join(root, "anno", "1608_song_id.mat"))


def test_annotations_hc_table_and_users_match(roots):
    mat, mapping = _paths(roots["amg"])
    ref = jax_amg.load_annotations(mat, mapping)
    got = amg.load_annotations(mat, mapping)
    for col in ("song_id", "user_id", "valence", "arousal", "quadrant"):
        np.testing.assert_array_equal(getattr(got, col), ref[col].values,
                                      err_msg=col)
    hc_ref = jax_amg.hc_frequency_table(ref)
    hc = amg.hc_frequency_table(got)
    np.testing.assert_array_equal(hc.song_ids, hc_ref.index.values)
    np.testing.assert_array_equal(hc.freq, hc_ref.to_numpy())
    probe = [hc.song_ids[3], 99999, hc.song_ids[0]]  # 99999: not annotated
    np.testing.assert_array_equal(
        hc.rows_for(probe), hc_ref.reindex(probe).to_numpy(np.float32))
    for n in (1, 30, 34, 10_000):
        f_ref, users_ref = jax_amg.filter_users(ref, n)
        f_got, users = amg.filter_users(got, n)
        assert users == users_ref
        np.testing.assert_array_equal(f_got.song_id, f_ref.song_id.values)


def _assert_pools_equal(got, ref):
    assert [str(s) for s in got.song_ids] == [str(s) for s in ref.song_ids]
    np.testing.assert_array_equal(got.counts, ref.counts)
    np.testing.assert_array_equal(got.X, ref.X)
    assert got.X.dtype == ref.X.dtype == np.float32


def test_feature_pool_from_csvs_and_either_cache(roots, tmp_path):
    feats = os.path.join(roots["amg"], "feats")
    ref = jax_amg.load_feature_pool(None, feats)
    _assert_pools_equal(amg.load_feature_pool(None, feats), ref)
    # each package reads the other's cache
    jax_cache, port_cache = (str(tmp_path / "jax.csv"),
                             str(tmp_path / "port.csv"))
    jax_amg.load_feature_pool(jax_cache, feats)
    amg.load_feature_pool(port_cache, feats)
    for cache in (jax_cache, port_cache):
        _assert_pools_equal(amg.load_feature_pool(cache, None), ref)
        _assert_pools_equal(jax_amg.load_feature_pool(cache, None), ref)
    unscaled = amg.load_feature_pool(port_cache, None, scale=False)
    _assert_pools_equal(unscaled,
                        jax_amg.load_feature_pool(jax_cache, None,
                                                  scale=False))


def test_feature_pool_newer_vintage_cache(tmp_path):
    df = amg_dataset_frame(np.random.default_rng(5), n_songs=40,
                           feature_cols=FEATURE_COLS_FFTMAG)
    cache = str(tmp_path / "dataset_feats.csv")
    df.to_csv(cache, sep=";", index=False)
    _assert_pools_equal(amg.load_feature_pool(cache),
                        jax_amg.load_feature_pool(cache))


def test_feature_pool_parsed_cache_follows_the_csv(roots, tmp_path,
                                                  monkeypatch):
    feats = os.path.join(roots["amg"], "feats")
    cache = str(tmp_path / "dataset.csv")
    amg.load_feature_pool(cache, feats)
    assert os.path.exists(cache + amg.PARSED_SUFFIX)
    ref = jax_amg.load_feature_pool(cache, None)
    with monkeypatch.context() as m:
        # a later read takes the parsed cache, not the text
        m.setattr(amg, "_read_table", None)
        _assert_pools_equal(amg.load_feature_pool(cache, None), ref)
        _assert_pools_equal(amg.load_feature_pool(cache, None, scale=False),
                            jax_amg.load_feature_pool(cache, None,
                                                      scale=False))
    # a rewritten CSV cache makes the parsed one stale
    other = str(tmp_path / "other.csv")
    amg_dataset_frame(np.random.default_rng(6), n_songs=30,
                      feature_cols=FEATURE_COLS_FFTMAG).to_csv(
        other, sep=";", index=False)
    os.replace(other, cache)
    ref = jax_amg.load_feature_pool(cache, None)
    _assert_pools_equal(amg.load_feature_pool(cache, None), ref)
    # a torn parsed cache is read past
    with open(cache + amg.PARSED_SUFFIX, "r+b") as f:
        f.truncate(20)
    _assert_pools_equal(amg.load_feature_pool(cache, None), ref)
    _assert_pools_equal(amg.load_feature_pool(cache, None), ref)


def test_user_pool_matches(roots):
    mat, mapping = _paths(roots["amg"])
    feats = os.path.join(roots["amg"], "feats")
    ref_anno, users = jax_amg.filter_users(
        jax_amg.load_annotations(mat, mapping), 10)
    got_anno, _ = amg.filter_users(amg.load_annotations(mat, mapping), 10)
    ref_pool = jax_amg.load_feature_pool(None, feats)
    pool = amg.load_feature_pool(None, feats)
    for u in users[:3]:
        sub_ref, lab_ref = jax_amg.user_pool(ref_pool, ref_anno, u)
        sub, lab = amg.user_pool(pool, got_anno, u)
        _assert_pools_equal(sub, sub_ref)
        assert lab == lab_ref
