"""``reproduce`` (the paper's pipeline on the port) on the CPU.

``reproduce --smoke --device cpu`` writes its synthetic tree with
``data/synth.py``, whose files are ``tests/synth_data.py``'s (the CSVs
byte for byte, the ``.mat`` annotations equal through both packages'
loaders), pre-trains gnb and sgd and runs mc and rand; every mode's
reports equal the port's ``deam_classifier`` and ``amg_test`` run one by
one on the same tree (queried song ids and F1s exactly), and the JAX
package's CLIs, in this process on the same tree, query the same songs
with F1s within F1_TOL.  Without ``--device`` it runs on the card and
raises without one."""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.cli import amg_test as jax_amg_test
from consensus_entropy_tpu.cli import deam_classifier as jax_deam
from consensus_entropy_tpu.data import amg as jax_amg
from consensus_entropy_tpu.data import deam as jax_deam_data
from consensus_entropy_tpu_torch.cli import amg_test, deam_classifier
from consensus_entropy_tpu_torch.cli import reproduce
from consensus_entropy_tpu_torch.data import amg, deam
from consensus_entropy_tpu_torch.data.synth import build_synth_roots
from tests.synth_data import build_synth_roots as pandas_synth_roots

torch.set_num_threads(1)

#: the JAX package's F1s against the port's: float64 means of the same
#: integer confusion counts, so equal but for the last bits
F1_TOL = 1e-12


def _metrics(models_root, mode):
    users = os.path.join(models_root, "users")
    out = {}
    for u in sorted(os.listdir(users)):
        path = os.path.join(users, u, mode, "metrics.jsonl")
        if os.path.exists(path):
            with open(path) as f:
                out[u] = [json.loads(line) for line in f]
    return out


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke")
    out = reproduce.smoke(str(root), "cpu", log=lambda *a: None)
    assert out["rc"] == 0
    return out


def test_synth_tree_matches_the_pandas_builder(tmp_path):
    ours = build_synth_roots(tmp_path / "port", np.random.default_rng(0))
    theirs = pandas_synth_roots(tmp_path / "jax", np.random.default_rng(0))
    csvs = 0
    for key in ("deam", "amg"):
        for dirpath, _, files in os.walk(theirs[key]):
            for name in files:
                ref = os.path.join(dirpath, name)
                got = ref.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
                assert os.path.exists(got), got
                if name.endswith(".csv"):
                    csvs += 1
                    assert filecmp.cmp(got, ref, shallow=False), name
    assert csvs == 24 + 2 + 40
    # the .mat annotations and the tables, through both packages' loaders
    for root in (ours, theirs):
        anno = os.path.join(root["amg"], "anno")
        mats = (os.path.join(anno, "AMG1608.mat"),
                os.path.join(anno, "1608_song_id.mat"))
        ref = jax_amg.load_annotations(*mats)
        got = amg.load_annotations(*mats)
        for col in ("song_id", "user_id", "valence", "arousal", "quadrant"):
            np.testing.assert_array_equal(getattr(got, col), ref[col].values)
        feats = os.path.join(root["amg"], "feats")
        pool = amg.load_feature_pool(None, feats)
        np.testing.assert_array_equal(
            pool.X, jax_amg.load_feature_pool(None, feats).X)
        d = os.path.join(root["deam"], "annotations")
        paths = (os.path.join(root["deam"], "features"),
                 os.path.join(d, "arousal.csv"), os.path.join(d, "valence.csv"))
        X, y, _ = deam.training_arrays(deam.load_dataset(*paths))
        Xj, yj, _ = jax_deam_data.training_arrays(
            jax_deam_data.load_dataset(*paths))
        np.testing.assert_array_equal(X, Xj)
        np.testing.assert_array_equal(y, yj)
    np.testing.assert_array_equal(
        amg.load_feature_pool(None, os.path.join(ours["amg"], "feats")).X,
        amg.load_feature_pool(None, os.path.join(theirs["amg"], "feats")).X)


def test_smoke_equals_the_clis_one_by_one(smoke, tmp_path):
    direct = str(tmp_path / "direct")
    flags = ["--models-root", direct, "--deam-root", smoke["deam"],
             "--amg-root", smoke["amg"], "--device", "cpu"]
    for model in reproduce.SMOKE["models"]:
        assert deam_classifier.main(["-cv", "2", "-m", model] + flags) == 0
    with open(os.path.join(smoke["models"], "pretrained",
                           "pretrain_metrics.jsonl")) as a, \
            open(os.path.join(direct, "pretrained",
                              "pretrain_metrics.jsonl")) as b:
        assert a.read() == b.read()
    for mode in reproduce.SMOKE["modes"]:
        assert amg_test.main(["-q", "2", "-e", "2", "-n", "4", "-m", mode,
                              "--mesh", "auto", "--max-users", "1"]
                             + flags) == 0
        ours, ref = _metrics(smoke["models"], mode), _metrics(direct, mode)
        assert len(ours) == 1 and ours == ref
        (recs,) = ours.values()
        assert [r["epoch"] for r in recs] == [-1, 0, 1]
    (mc,) = _metrics(smoke["models"], "mc").values()
    queried = [r.get("queried") for r in mc]
    assert queried[0] is None and all(len(q) == 2 for q in queried[1:])
    assert queried == [r.get("queried")
                       for r in next(iter(_metrics(direct, "mc").values()))]
    # the pipeline's record of its calls: these argvs, in this order
    assert [(c["cli"], c["argv"], c["rc"]) for c in smoke["calls"]] == [
        ("deam_classifier", ["-cv", "2", "-m", m], 0)
        for m in reproduce.SMOKE["models"]] + [
        ("amg_test", ["-q", "2", "-e", "2", "-n", "4", "-m", m, "--mesh",
                      "auto", "--max-users", "1"], 0)
        for m in reproduce.SMOKE["modes"]]
    starts = [c["start"] for c in smoke["calls"]]
    assert starts == sorted(starts)
    assert all(c["seconds"] > 0 for c in smoke["calls"])


def test_smoke_matches_the_jax_clis(smoke, tmp_path):
    models = str(tmp_path / "jax")
    flags = ["--models-root", models, "--deam-root", smoke["deam"],
             "--amg-root", smoke["amg"], "--device", "cpu"]
    for model in reproduce.SMOKE["models"]:
        assert jax_deam.main(["-cv", "2", "-m", model] + flags) == 0
    for mode in ("mc", "rand"):
        assert jax_amg_test.main(["-q", "2", "-e", "2", "-n", "4", "-m",
                                  mode, "--max-users", "1"] + flags) == 0
        ours, theirs = _metrics(smoke["models"], mode), _metrics(models,
                                                                  mode)
        assert sorted(ours) == sorted(theirs) and len(ours) == 1
        for u in ours:
            assert len(ours[u]) == len(theirs[u]) == 3
            for a, b in zip(ours[u], theirs[u]):
                assert a.get("queried") == b.get("queried")
                np.testing.assert_allclose(a["f1"], b["f1"], rtol=0,
                                           atol=F1_TOL)


def test_cli_smoke_and_the_card_default(tmp_path, capsys):
    assert reproduce.main(["--smoke", "--device", "cpu"]) == 0
    assert "done: per-user reports" in capsys.readouterr().out
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reproduce.main([str(tmp_path / "m"), str(tmp_path / "d"),
                        str(tmp_path / "a")])
