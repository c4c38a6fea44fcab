"""The port's boosted slot against the JAX package's, on the CPU.

The same seeded data go through JAX ``models/gbdt.py`` (whose tree build
and margins run in its own C++ core or its numpy version, both held equal
by the JAX package) and through the port's ``models/gbdt.py`` with its own
host core (``native.py`` + ``native/ce_gbdt.cpp``, built here with g++).
Tolerance 0 throughout: bin edges and codes, trees, margins and
probabilities are bit-equal, the C++ core bit-equal to its numpy plain
version.  Continued boosting keeps all four classes on a class-deficient
batch, member files round-trip, a JAX pickle converts, and a broken build
raises instead of falling back."""

import os
import pickle

import numpy as np
import pytest
import torch

from consensus_entropy_tpu import native as jax_native
from consensus_entropy_tpu.models.gbdt import GBDT as JaxGBDT
from consensus_entropy_tpu.models.gbdt import NativeGBDTMember as JaxMember
from consensus_entropy_tpu.models.gbdt import QuantileBinner as JaxBinner
from consensus_entropy_tpu_torch import convert, native
from consensus_entropy_tpu_torch.models.gbdt import (
    GBDT,
    NativeGBDTMember,
    QuantileBinner,
)
from consensus_entropy_tpu_torch.models.members import MEMBER_TYPES

torch.set_num_threads(1)


def _data(seed, n=300, f=12, n_class=4):
    rng = np.random.default_rng(seed)
    y = np.arange(n) % n_class
    rng.shuffle(y)
    centers = rng.standard_normal((n_class, f)) * 1.5
    x = (rng.standard_normal((n, f)) + centers[y]).astype(np.float32)
    x[:, 0] = np.round(x[:, 0])  # ties on the quantile edges
    return x, y


def _trees_equal(a, b):
    return all(np.array_equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("n_bins", [2, 16, 256])
def test_binner_edges_and_codes_match_jax(n_bins):
    x, _ = _data(0)
    ours, theirs = QuantileBinner(n_bins).fit(x), JaxBinner(n_bins).fit(x)
    assert len(ours.edges) == x.shape[1]
    for a, b in zip(ours.edges, theirs.edges):
        np.testing.assert_array_equal(a, b)
    probe = np.concatenate([x, x + 0.25, np.stack(
        [np.pad(e[:1], (0, 0)) for e in ours.edges], 1).repeat(2, 0)])
    codes = ours.transform(probe)
    np.testing.assert_array_equal(codes, theirs.transform(probe))
    # a value equal to an edge lands in the lower bin: (lo, hi]
    assert codes.dtype == np.uint8 and (codes[-1] == 0).all()


@pytest.mark.parametrize("max_depth, n_bins, lam, mcw, min_gain", [
    (5, 256, 1.0, 1.0, 0.0),
    (3, 16, 1.0, 1.0, 0.0),
    (0, 32, 1.0, 1.0, 0.0),
    (4, 64, 0.0, 0.0, 0.0),   # 0/0 gains must lose the argmax
    (6, 256, 2.0, 0.5, 0.1),
])
def test_tree_matches_jax_and_plain(max_depth, n_bins, lam, mcw, min_gain):
    x, y = _data(1, n=400)
    xb = JaxBinner(n_bins).fit(x).transform(x)
    rng = np.random.default_rng(2)
    g = rng.standard_normal(len(y)).astype(np.float32)
    h = rng.uniform(0.05, 0.3, len(y)).astype(np.float32)
    kw = dict(max_depth=max_depth, n_bins=n_bins, lam=lam,
              min_child_weight=mcw, min_gain=min_gain)
    core = native.gbdt_build_tree(xb, g, h, **kw)
    plain = native.gbdt_build_tree(xb, g, h, plain=True, **kw)
    ref = jax_native._gbdt_build_tree_np(xb, g, h, max_depth, n_bins, lam,
                                         mcw, min_gain)
    assert _trees_equal(core, plain) and _trees_equal(core, ref)
    assert core[0].shape == (2 ** (max_depth + 1) - 1,)


def test_margins_match_jax_and_plain():
    x, y = _data(3)
    xb = QuantileBinner(64).fit(x).transform(x)
    model = GBDT(4, max_depth=4, n_bins=64).boost(xb, y, 3)
    st = model.state()
    args = (xb, st["feature"], st["threshold"], st["value"],
            st["tree_class"], 4, model.learning_rate)
    core = native.gbdt_predict_margins(*args)
    np.testing.assert_array_equal(
        core, native.gbdt_predict_margins(*args, plain=True))
    np.testing.assert_array_equal(core, jax_native.gbdt_predict_margins(
        *args))
    # accumulating into given margins: the same sums in both versions
    base = np.random.default_rng(9).standard_normal((len(xb), 4))
    got = native.gbdt_predict_margins(*args, margins=base.copy())
    np.testing.assert_array_equal(got, native.gbdt_predict_margins(
        *args, margins=base.copy(), plain=True))
    np.testing.assert_allclose(got, core + base, rtol=1e-12, atol=1e-12)


def test_boost_matches_jax():
    x, y = _data(4)
    xb = JaxBinner().fit(x).transform(x)
    ours = GBDT(4, max_depth=5).boost(xb, y, 4)
    theirs = JaxGBDT(4, max_depth=5).boost(xb, y, 4)
    for k, v in theirs.state().items():
        np.testing.assert_array_equal(ours.state()[k], v, err_msg=k)
    np.testing.assert_array_equal(ours.predict_proba(xb),
                                  theirs.predict_proba(xb))
    assert ours.n_trees == 16


def test_member_fit_and_class_deficient_update_match_jax():
    x, y = _data(5)
    ours = NativeGBDTMember("xgb", n_estimators=5, update_estimators=3)
    theirs = JaxMember("xgb", n_estimators=5, update_estimators=3)
    ours.fit(x, y)
    theirs.fit(x, y)
    xq, yq = x[:30], np.where(y[:30] % 2 == 0, 0, 1)  # classes 0, 1 only
    ours.update(xq, yq)
    theirs.update(xq, yq)
    np.testing.assert_array_equal(ours.predict_proba(x),
                                  theirs.predict_proba(x))
    np.testing.assert_array_equal(ours.predict(x), theirs.predict(x))
    # every class got its trees in every round, the absent ones too
    counts = np.bincount(ours.model.state()["tree_class"], minlength=4)
    assert counts.tolist() == [8, 8, 8, 8]
    assert MEMBER_TYPES["xgb"] is NativeGBDTMember


def test_fit_requires_every_class_and_resets_the_binner():
    x, y = _data(6)
    with pytest.raises(ValueError, match="all 4 classes"):
        NativeGBDTMember(n_estimators=2).fit(x, y % 3)
    m = NativeGBDTMember(n_estimators=2).fit(x, y)
    edges = [e.copy() for e in m.binner.edges]
    m.fit(x * 2, y)
    assert not np.array_equal(edges[1], m.binner.edges[1])
    assert m.model.n_trees == 8


def test_npz_round_trip_and_crc(tmp_path):
    x, y = _data(7)
    m = NativeGBDTMember("xgb.it_0", n_estimators=3).fit(x, y)
    path = str(tmp_path / "classifier_xgb.xgb.it_0.npz")
    m.save(path)
    back = NativeGBDTMember.load(path)
    assert (back.name, back.n_estimators, back.update_estimators) == (
        "xgb.it_0", 3, 3)
    np.testing.assert_array_equal(back.predict_proba(x), m.predict_proba(x))
    back.update(x[:20], y[:20])
    m.update(x[:20], y[:20])
    np.testing.assert_array_equal(back.predict_proba(x), m.predict_proba(x))
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC32"):
        NativeGBDTMember.load(path)


def test_jax_pickle_converts(tmp_path):
    x, y = _data(8)
    theirs = JaxMember("xgb.it_0", n_estimators=3).fit(x, y)
    src = tmp_path / "jax"
    src.mkdir()
    theirs.save(str(src / "classifier_xgb.xgb.it_0.pkl"))
    written = convert.registry_from_jax(str(src), str(tmp_path / "port"))
    assert written == ["classifier_xgb.xgb.it_0.npz"]
    ours = NativeGBDTMember.load(str(tmp_path / "port" / written[0]))
    np.testing.assert_array_equal(ours.predict_proba(x),
                                  theirs.predict_proba(x))
    (direct,) = convert.host_members_from_jax([theirs])
    np.testing.assert_array_equal(direct.predict_proba(x),
                                  theirs.predict_proba(x))
    # a boosted member of another format is refused by name
    with open(src / "classifier_xgb.other.pkl", "wb") as f:
        pickle.dump({"kind": "xgb", "name": "other", "raw": b""}, f)
    with pytest.raises(ValueError, match="not ported"):
        convert.registry_from_jax(str(src), str(tmp_path / "port2"))


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    bad = tmp_path / "ce_gbdt.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="GBDT core build failed"):
        native.gbdt_build_tree(np.zeros((4, 2), np.uint8), np.zeros(4),
                               np.ones(4), max_depth=2, n_bins=4)
    assert not [f for f in os.listdir(tmp_path / "_build")
                if f.endswith(".so")]
    # the plain version runs only when asked for
    tree = native.gbdt_build_tree(np.zeros((4, 2), np.uint8), np.zeros(4),
                                  np.ones(4), max_depth=2, n_bins=4,
                                  plain=True)
    assert tree[0].tolist() == [-1] * 7


def test_input_checks():
    xb = np.zeros((5, 3), np.uint8)
    with pytest.raises(ValueError, match="shape mismatch"):
        native.gbdt_build_tree(xb, np.zeros(4), np.ones(5), max_depth=2,
                               n_bins=8)
    with pytest.raises(ValueError, match="n_bins"):
        native.gbdt_build_tree(xb, np.zeros(5), np.ones(5), max_depth=2,
                               n_bins=1)
    with pytest.raises(ValueError, match="bin codes"):
        native.gbdt_build_tree(xb + 9, np.zeros(5), np.ones(5), max_depth=2,
                               n_bins=8)
    f = np.full((1, 7), -1, np.int32)
    with pytest.raises(ValueError, match="margins"):
        native.gbdt_predict_margins(xb, f, f, np.zeros((1, 7)),
                                    np.zeros(1, np.int32), 4, 0.3,
                                    margins=np.zeros((5, 4), np.float32))
    with pytest.raises(ValueError, match="tree_class"):
        native.gbdt_predict_margins(xb, f, f, np.zeros((1, 7)),
                                    np.full(1, 4, np.int32), 4, 0.3)
    with pytest.raises(ValueError, match="labels"):
        GBDT(4, max_depth=2).boost(xb, np.array([0, 1, 2, 3, 4]), 1)
