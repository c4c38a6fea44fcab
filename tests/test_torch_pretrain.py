"""The port's DEAM pre-trainer against the JAX package's, on the CPU.

Grouped folds are equal; the classic fold members (GaussianNB, SGD, the
boosted trees, whose JAX member here is its native GBDT: this box has no
xgboost) predict bit-equal probabilities and the CV summaries are equal,
with a process pool too; scikit-learn's other kinds (rf, svc, knn, gpc,
gbc) pre-train to the JAX pre-trainer's metrics and printed lines.
CNN folds at the evidence's narrow geometry start from JAX's initial
variables bit for bit and end within C4's tolerances (losses rtol 1e-3 /
atol 1e-4, weights rtol 1e-3 / atol 2e-3).  Resume skips a matching fold
and refuses a stale one; a write killed before its rename leaves only a
``.tmp`` that no reader takes; a non-vgg fold file loads through the
workspace; a converted JAX registry has the port's file names.  The SGD
member's C++ loop equals its Python plain version bit for bit, also
through the branch that folds a vanishing weight scale into the weights."""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from consensus_entropy_tpu.config import CNNConfig as JaxCNNConfig
from consensus_entropy_tpu.config import TrainConfig as JaxTrainConfig
from consensus_entropy_tpu.data.audio import DeviceWaveformStore as JaxStore
from consensus_entropy_tpu.models import cnn_trainer as jax_trainer
from consensus_entropy_tpu.models import short_cnn as jax_cnn
from consensus_entropy_tpu.train import pretrain as jax_pretrain
from consensus_entropy_tpu.utils.checkpoint import save_variables
from consensus_entropy_tpu_torch import convert, prng
from consensus_entropy_tpu_torch.al import workspace
from consensus_entropy_tpu_torch.al.evidence import CNN_CFG
from consensus_entropy_tpu_torch.config import CNNConfig, TrainConfig
from consensus_entropy_tpu_torch.data.audio import DeviceWaveformStore
from consensus_entropy_tpu_torch.models import base, cnn_trainer, short_cnn
from consensus_entropy_tpu_torch.models.committee import CNNMember, Committee
from consensus_entropy_tpu_torch.models.members import (
    MEMBER_TYPES,
    GNBMember,
    _dloss,
    plain_sgd,
)
from consensus_entropy_tpu_torch.train import pretrain

torch.set_num_threads(1)

CNN_KW = {k: getattr(CNN_CFG, k) for k in ("n_channels", "n_fft",
                                           "hop_length", "n_mels",
                                           "n_layers", "input_length")}
JAX_CNN = JaxCNNConfig(**CNN_KW)
BATCH = 4
CNN_SEED, CNN_EPOCHS, CNN_SONGS = 11, 2, 12


def _classic_data(seed, n_songs=40, n_feat=12):
    """Class-separable frames of ``n_songs`` songs, 3-8 frames a song."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4, n_feat)) * 1.5
    X, y, sids = [], [], []
    for s in range(n_songs):
        c, k = s % 4, int(rng.integers(3, 9))
        X.append(centers[c] + rng.standard_normal((k, n_feat)))
        y += [c] * k
        sids += [100 + s] * k
    return (np.vstack(X).astype(np.float32), np.asarray(y, np.int32),
            np.asarray(sids))


def test_grouped_folds_equal_jax():
    sids = np.random.default_rng(0).integers(0, 57, 400)
    for n in (1, 5):
        got = list(pretrain.grouped_folds(sids, n,
                                          np.random.default_rng(3)))
        want = list(jax_pretrain.grouped_folds(sids, n,
                                               np.random.default_rng(3)))
        assert len(got) == n
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    # CNN folds split an object array of song ids the same way
    songs = np.array(list(range(30, 0, -1)), dtype=object)
    got = next(pretrain.grouped_folds(songs, 1, np.random.default_rng(1)))
    want = next(jax_pretrain.grouped_folds(songs, 1,
                                           np.random.default_rng(1)))
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("model, n_songs, cv", [
    ("gnb", 40, 3), ("sgd", 40, 3), ("xgb", 320, 1)])
def test_classic_folds_equal_jax(tmp_path, capsys, model, n_songs, cv):
    """Fold members' probabilities bit-equal with the JAX pickles'
    (converted), the summary and the jsonl record equal; xgb at 100
    rounds on about 1,800 frames."""
    X, y, sids = _classic_data(5, n_songs)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jax_pretrain.pretrain_classic(model, X, y, sids, cv=cv,
                                         out_dir=jdir, seed=7)
    jax_out = capsys.readouterr().out
    got = pretrain.pretrain_classic(model, X, y, sids, cv=cv, out_dir=pdir,
                                    seed=7)
    assert got == want and capsys.readouterr().out == jax_out
    with open(os.path.join(jdir, "pretrain_metrics.jsonl")) as a, \
            open(os.path.join(pdir, "pretrain_metrics.jsonl")) as b:
        assert a.read() == b.read()
    conv = convert.registry_from_jax(jdir, str(tmp_path / "conv"))
    files = sorted(f for f in os.listdir(pdir) if f.endswith(".npz"))
    assert files == sorted(conv) == [f"classifier_{model}.it_{i}.npz"
                                     for i in range(cv)]
    for f in files:
        a = MEMBER_TYPES[model].load(os.path.join(pdir, f))
        b = MEMBER_TYPES[model].load(str(tmp_path / "conv" / f))
        np.testing.assert_array_equal(a.predict_proba(X), b.predict_proba(X))
    if model == "xgb":
        assert a.model.n_trees == 100 * 4


def test_process_pool_equals_sequential(tmp_path):
    X, y, sids = _classic_data(6)
    seq = pretrain.pretrain_classic("sgd", X, y, sids, cv=3,
                                    out_dir=str(tmp_path / "seq"), seed=3)
    par = pretrain.pretrain_classic("sgd", X, y, sids, cv=3,
                                    out_dir=str(tmp_path / "par"), seed=3,
                                    n_jobs=2)
    assert par == seq
    for d in ("seq", "par"):
        assert sorted(os.listdir(tmp_path / d)) == [
            "classifier_sgd.it_0.npz", "classifier_sgd.it_1.npz",
            "classifier_sgd.it_2.npz", "pretrain_metrics.jsonl"]
    for i in range(3):
        a, b = (MEMBER_TYPES["sgd"].load(
            str(tmp_path / d / f"classifier_sgd.it_{i}.npz"))
            for d in ("seq", "par"))
        np.testing.assert_array_equal(a.coef_, b.coef_)


@pytest.mark.parametrize("kind", ["rf", "svc", "knn", "gpc", "gbc"])
def test_sklearn_kinds_are_refused_by_name(tmp_path, capsys, kind):
    """Every scikit-learn kind of the registry pre-trains in the port (the
    name is the refusal this test held before they did): two folds return
    the JAX pre-trainer's metrics exactly, print its lines and write its
    metrics line; each fold member predicts the JAX fold estimator's
    classes on every row; knn's stored rows, labels and classes are
    scikit-learn's."""
    import pickle

    from threadpoolctl import threadpool_limits

    X, y, sids = _classic_data(1)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    # one BLAS thread for both: gpc's products sum in the order the
    # thread count gives, and small ones run faster on one
    with threadpool_limits(limits=1, user_api="blas"):
        want = jax_pretrain.pretrain_classic(kind, X, y, sids, cv=2,
                                             out_dir=jdir, seed=7)
        jax_out = capsys.readouterr().out
        got = pretrain.pretrain_classic(kind, X, y, sids, cv=2,
                                        out_dir=pdir, seed=7)
    assert got == want and capsys.readouterr().out == jax_out
    with open(os.path.join(jdir, "pretrain_metrics.jsonl")) as a, \
            open(os.path.join(pdir, "pretrain_metrics.jsonl")) as b:
        assert a.read() == b.read()
    for i in range(2):
        with open(os.path.join(jdir, f"classifier_{kind}.it_{i}.pkl"),
                  "rb") as f:
            est = pickle.load(f)["estimator"]
        ours = MEMBER_TYPES[kind].load(
            os.path.join(pdir, f"classifier_{kind}.it_{i}.npz"))
        np.testing.assert_array_equal(ours.predict(X), est.predict(X))
        if kind == "knn":
            np.testing.assert_array_equal(ours.state["fit_X"], est._fit_X)
            np.testing.assert_array_equal(ours.state["y"], est._y)
            np.testing.assert_array_equal(ours.state["classes"],
                                          est.classes_)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("max_iter", [1, 40])
def test_sgd_core_equals_its_plain_version(dtype, max_iter):
    rng = np.random.default_rng(int(max_iter))
    X = rng.standard_normal((700, 23)).astype(dtype)
    y = (X[:, 0] + 0.8 * rng.standard_normal(700) > 0).astype(dtype)
    w0 = (0.1 * rng.standard_normal(23)).astype(dtype)  # a warm start
    out = []
    for plain in (True, False):
        w = w0.copy()
        out.append((w, plain_sgd(w, 0.25, X, y, seed=987654, max_iter=max_iter,
                                 t=3.0, alpha=1e-4, tol=1e-3,
                                 n_iter_no_change=5, plain=plain)))
    (w_plain, r_plain), (w_core, r_core) = out
    assert r_core == r_plain
    np.testing.assert_array_equal(w_core, w_plain)


def _rescales(dtype, alpha, t, steps):
    """How often ``plain_sgd``'s weight scale falls below its threshold
    (the branch that folds it into the weights) over ``steps`` updates
    from ``t``: the schedule alone decides it."""
    dt = np.dtype(dtype).type
    threshold = 1e-6 if dtype == np.float32 else 1e-9
    typw = math.sqrt(1.0 / math.sqrt(alpha))
    optimal_init = 1.0 / (typw / max(1.0, _dloss(1.0, -typw)) * alpha)
    wscale, n = 1.0, 0
    for _ in range(steps):
        eta = 1.0 / (alpha * (optimal_init + t - 1))
        wscale *= float(dt(max(0.0, 1.0 - eta * alpha)))
        if wscale < threshold:
            n, wscale = n + 1, 1.0
        t += 1
    return n


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("alpha", [1.0, 1e3])
def test_sgd_core_equals_its_plain_version_through_rescales(dtype, alpha):
    """A strong penalty from ``t = 1``: the first step's decay is 0 and
    (float32, alpha 1e3) the scale later falls below the threshold."""
    rng = np.random.default_rng(40)
    X = rng.standard_normal((1500, 23)).astype(dtype)
    y = (X[:, 0] + 0.8 * rng.standard_normal(1500) > 0).astype(dtype)
    w0 = (0.1 * rng.standard_normal(23)).astype(dtype)
    out = []
    for plain in (True, False):
        w = w0.copy()
        out.append((w, plain_sgd(w, 0.25, X, y, seed=987654, max_iter=40,
                                 t=1.0, alpha=alpha, tol=1e-3,
                                 n_iter_no_change=5, plain=plain)))
    (w_plain, r_plain), (w_core, r_core) = out
    assert r_core == r_plain
    np.testing.assert_array_equal(w_core, w_plain)
    want = 2 if (dtype, alpha) == (np.float32, 1e3) else 1
    assert _rescales(dtype, alpha, 1.0, len(X) * r_plain[1]) == want


# -- the CNN folds -----------------------------------------------------------


@pytest.fixture(scope="module")
def cnn_runs(tmp_path_factory):
    """JAX's and the port's ``pretrain_cnn`` on the same tone clips: 2
    folds, 2 epochs, each fit's history recorded."""
    from consensus_entropy_tpu_torch.al.evidence import synth_tone

    root = tmp_path_factory.mktemp("cnn")
    rng = np.random.default_rng(4)
    labels = {200 + s: s % 4 for s in range(CNN_SONGS)}
    waves = {sid: synth_tone(c, 2048 + int(rng.integers(100, 900)), rng,
                             sample_rate=16000)
             for sid, c in labels.items()}
    hist = {"jax": [], "port": []}
    jfit, pfit = jax_trainer.CNNTrainer.fit, cnn_trainer.CNNTrainer.fit

    def rec(name, fit):
        def wrapped(self, *a, **kw):
            out = fit(self, *a, **kw)
            hist[name].append(out[1])
            return out
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_trainer.CNNTrainer, "fit", rec("jax", jfit))
    mp.setattr(cnn_trainer.CNNTrainer, "fit", rec("port", pfit))
    try:
        jax_pretrain.pretrain_cnn(
            labels, JaxStore(waves, 2048), cv=2, out_dir=str(root / "jax"),
            config=JAX_CNN, train_config=JaxTrainConfig(batch_size=BATCH),
            n_epochs=CNN_EPOCHS, seed=CNN_SEED)
        store = DeviceWaveformStore(waves, 2048, "cpu")
        pretrain.pretrain_cnn(
            labels, store, cv=2, out_dir=str(root / "port"), config=CNN_CFG,
            train_config=TrainConfig(batch_size=BATCH), n_epochs=CNN_EPOCHS,
            seed=CNN_SEED)
    finally:
        mp.undo()
    return root, labels, store, hist


def test_cnn_folds_match_jax(cnn_runs):
    root, _, _, hist = cnn_runs
    for i in range(2):
        key = jax.random.fold_in(jax.random.key(CNN_SEED + i), 0)
        want = convert.cnn_variables_from_jax(
            jax_cnn.init_variables(key, JAX_CNN), CNN_CFG, "cpu")
        got = short_cnn.init_variables(
            prng.fold_in(prng.key(CNN_SEED + i, "cpu"), 0), CNN_CFG, "cpu")
        for k, t in got.items():  # C12: bit for bit
            np.testing.assert_array_equal(t.numpy(), want[k].numpy(),
                                          err_msg=k)
        jvars, meta = convert.read_cetpu_checkpoint(
            str(root / "jax" / f"classifier_cnn.it_{i}.msgpack"))
        ref = convert.cnn_variables_from_jax(jvars, CNN_CFG, "cpu")
        port = CNNMember.load(str(root / "port" / f"classifier_cnn.it_{i}.npz"),
                              CNN_CFG, "cpu")
        for k, t in port.variables.items():
            np.testing.assert_allclose(t.numpy(), ref[k].numpy(), rtol=1e-3,
                                       atol=2e-3, err_msg=k)
        for e, er in zip(hist["port"][i], hist["jax"][i]):
            assert e["phase"] == er["phase"]
            for k in ("train_loss", "val_loss"):
                np.testing.assert_allclose(e[k], er[k], rtol=1e-3,
                                           atol=1e-4, err_msg=k)
    recs = {}
    for name in ("jax", "port"):
        with open(root / name / "pretrain_metrics.jsonl") as f:
            recs[name] = [json.loads(x) for x in f][-1]
    print(f"fold F1s: port {recs['port']['fold_f1']}, "
          f"JAX {recs['jax']['fold_f1']}")
    assert recs["port"]["model"] == recs["jax"]["model"] == "cnn_jax"
    assert len(recs["port"]["fold_f1"]) == 2


def test_cnn_resume_skips_and_refuses_a_stale_fold(cnn_runs, capsys):
    root, labels, store, _ = cnn_runs
    out = str(root / "port")
    files = [os.path.join(out, f"classifier_cnn.it_{i}.npz") for i in (0, 1)]
    before = [open(f, "rb").read() for f in files]
    pretrain.pretrain_cnn(labels, store, cv=2, out_dir=out, config=CNN_CFG,
                          train_config=TrainConfig(batch_size=BATCH),
                          n_epochs=CNN_EPOCHS, seed=CNN_SEED, resume=True)
    assert capsys.readouterr().out.count("resuming from") == 2
    assert [open(f, "rb").read() for f in files] == before
    with pytest.raises(ValueError, match="n_epochs"):
        pretrain.pretrain_cnn(labels, store, cv=2, out_dir=out,
                              config=CNN_CFG,
                              train_config=TrainConfig(batch_size=BATCH),
                              n_epochs=CNN_EPOCHS + 1, seed=CNN_SEED,
                              resume=True)


def test_killed_write_leaves_only_a_tmp(tmp_path, monkeypatch):
    X, y, _ = _classic_data(2)
    member = GNBMember("it_0").fit(X, y)
    path = str(tmp_path / "classifier_gnb.it_0.npz")

    def killed(src, dst):
        raise KeyboardInterrupt("killed between write and rename")

    monkeypatch.setattr(base.os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        member.save(path)
    monkeypatch.undo()
    assert os.listdir(tmp_path) == ["classifier_gnb.it_0.npz.tmp"]
    assert workspace.member_files(str(tmp_path)) == []
    member.save(path)  # a whole write lands under the name
    assert workspace.member_files(str(tmp_path)) == [
        "classifier_gnb.it_0.npz"]


def test_a_killed_cnn_fold_is_retrained_on_resume(cnn_runs, tmp_path,
                                                   monkeypatch, capsys):
    _, labels, store, _ = cnn_runs
    calls = []
    real = base.os.replace

    def kill_first(src, dst):
        calls.append(dst)
        if len(calls) == 1:
            raise KeyboardInterrupt("killed")
        real(src, dst)

    monkeypatch.setattr(base.os, "replace", kill_first)
    kw = dict(cv=1, out_dir=str(tmp_path), config=CNN_CFG,
              train_config=TrainConfig(batch_size=BATCH), n_epochs=1,
              seed=CNN_SEED, resume=True)
    with pytest.raises(KeyboardInterrupt):
        pretrain.pretrain_cnn(labels, store, **kw)
    pretrain.pretrain_cnn(labels, store, **kw)
    assert "resuming" not in capsys.readouterr().out  # the .tmp is no fold
    assert os.path.exists(tmp_path / "classifier_cnn.it_0.npz")


@pytest.mark.parametrize("fname, kind", [
    ("classifier_cnn_res.it_0.npz", "cnn"),
    ("classifier_cnn_musicnn.x.npz", "cnn"),
    ("classifier_cnn.it_0.npz", "cnn"),
    ("classifier_cnn_resnet.it_0.npz", None),
    ("classifier_rf.it_0.npz", "rf"),
])
def test_member_kind_takes_arch_tagged_cnn_files(fname, kind):
    if kind is None:
        with pytest.raises(workspace.UnportedMemberError,
                           match=fname.split(".")[0][11:]):
            workspace._member_kind(fname)
    else:
        assert workspace._member_kind(fname) == kind


def test_res_fold_loads_through_the_workspace(cnn_runs, tmp_path):
    _, labels, store, _ = cnn_runs
    res = CNNConfig(arch="res", **CNN_KW)
    pretrain.pretrain_cnn(labels, store, cv=1, out_dir=str(tmp_path),
                          config=res,
                          train_config=TrainConfig(batch_size=BATCH),
                          n_epochs=1, seed=3)
    assert "classifier_cnn_res.it_0.npz" in os.listdir(tmp_path)
    com = workspace.load_committee(str(tmp_path), CNN_CFG, device="cpu")
    (m,) = com.cnn_members
    assert m.config.arch == "res" and m.name == "it_0"
    # saved back under the same name: one file a member in a workspace
    assert Committee.member_file(m) == "classifier_cnn_res.it_0.npz"


def test_converted_jax_registry_has_the_port_names(tmp_path):
    """A JAX registry (classic pickles and arch-tagged CNN checkpoints)
    converts to the file names the port's pre-trainer writes."""
    X, y, sids = _classic_data(8)
    jdir = str(tmp_path / "jax")
    for model in ("gnb", "sgd"):
        jax_pretrain.pretrain_classic(model, X, y, sids, cv=2, out_dir=jdir)
    res = JaxCNNConfig(arch="res", **CNN_KW)
    save_variables(os.path.join(jdir, "classifier_cnn_res.it_0.msgpack"),
                   jax_cnn.init_variables(jax.random.key(0), res),
                   meta={"kind": "cnn_jax", "name": "it_0", "arch": "res"})
    written = convert.registry_from_jax(jdir, str(tmp_path / "port"),
                                        CNN_CFG)
    assert sorted(written) == [
        "classifier_cnn_res.it_0.npz", "classifier_gnb.it_0.npz",
        "classifier_gnb.it_1.npz", "classifier_sgd.it_0.npz",
        "classifier_sgd.it_1.npz"]
    com = workspace.load_committee(str(tmp_path / "port"), CNN_CFG,
                                   device="cpu")
    assert [m.config.arch for m in com.cnn_members] == ["res"]
    assert len(com.host_members) == 4
