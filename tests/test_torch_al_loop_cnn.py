"""The port's AL loop and CLI with the paper's committee kinds against the
JAX package's, on the CPU.

A synthetic user (24 songs with frame features and waveforms) and a
committee of GaussianNB, SGD, GBDT (``xgb``) and two TINY vgg CNN members
go through JAX ``ALLoop`` and the port's, for mc, qbdc and wmc over two
iterations with one retrain epoch: the queried songs are equal, the host
members' F1s equal exactly and the CNN members' within 1e-6 (argmax of
scores within atol 1e-5), and the per-user key stream ends equal.  A run
killed at its second state commit resumes to the uninterrupted end state
(float32 CNN checkpoints); a converted JAX workspace with a res member
resumes twice with one file a member.  The CLI personalizes a ``tests/synth_data.py``
tree from a JAX registry (pickles and a ``.msgpack`` CNN member) converted
by ``convert.registry_from_jax``, as the JAX CLI does from the original."""

import copy
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from consensus_entropy_tpu.al.loop import ALLoop as JaxLoop
from consensus_entropy_tpu.al.loop import UserData as JaxUserData
from consensus_entropy_tpu.cli import amg_test as jax_amg_test
from consensus_entropy_tpu.config import ALConfig as JaxALConfig
from consensus_entropy_tpu.config import CNNConfig as JaxCNNConfig
from consensus_entropy_tpu.config import TrainConfig as JaxTrainConfig
from consensus_entropy_tpu.data.audio import DeviceWaveformStore as JaxStore
from consensus_entropy_tpu.models import short_cnn as jax_cnn
from consensus_entropy_tpu.models.committee import CNNMember as JaxCNN
from consensus_entropy_tpu.models.committee import Committee as JaxCommittee
from consensus_entropy_tpu.models.committee import FramePool as JaxPool
from consensus_entropy_tpu.models.gbdt import NativeGBDTMember as JaxGBDT
from consensus_entropy_tpu.models.sklearn_members import GNBMember as JaxGNB
from consensus_entropy_tpu.models.sklearn_members import SGDMember as JaxSGD
from consensus_entropy_tpu_torch import convert
from consensus_entropy_tpu_torch.al import state as al_state
from consensus_entropy_tpu_torch.al import workspace
from consensus_entropy_tpu_torch.al.loop import ALLoop, UserData
from consensus_entropy_tpu_torch.cli import amg_test
from consensus_entropy_tpu_torch.config import ALConfig, CNNConfig
from consensus_entropy_tpu_torch.config import TrainConfig
from consensus_entropy_tpu_torch.data.audio import DeviceWaveformStore
from consensus_entropy_tpu_torch.models.committee import (
    CNNMember,
    Committee,
    FramePool,
)
from consensus_entropy_tpu_torch.resilience import faults
from tests.synth_data import build_synth_roots

torch.set_num_threads(1)

TINY_KW = dict(n_channels=4, n_mels=32, n_layers=5, input_length=8192)
TINY, JAX_TINY = CNNConfig(**TINY_KW), JaxCNNConfig(**TINY_KW)
TC, JAX_TC = TrainConfig(batch_size=2), JaxTrainConfig(batch_size=2)
Q, EPOCHS, SEED, RETRAIN = 3, 2, 11, 1
_init = jax.jit(lambda k: jax_cnn.init_variables(k, JAX_TINY))


def _host_members(x, y):
    """GaussianNB, SGD and GBDT members fitted on noisy frames."""
    return [JaxGNB("gnb.it_0").fit(x, y),
            JaxSGD("sgd.it_0", seed=0).fit(x, y),
            JaxGBDT("xgb.it_0", n_estimators=3, update_estimators=2).fit(
                x, y)]


@pytest.fixture(scope="module")
def user():
    rng = np.random.default_rng(1987)
    centers = rng.standard_normal((4, 8)).astype(np.float32) * 2.5
    rows, sids, labels = [], [], {}
    for i in range(24):
        sid, c = 200 + i, int(rng.integers(0, 4))
        labels[sid] = c
        k = int(rng.integers(3, 6))
        rows.append(centers[c] + rng.standard_normal((k, 8)).astype(
            np.float32))
        sids += [sid] * k
    x = np.vstack(rows)
    waves = {s: rng.standard_normal(int(rng.integers(8300, 9500))).astype(
        np.float32) for s in labels}
    noisy = x + rng.standard_normal(x.shape).astype(np.float32) * 4
    host = _host_members(noisy, np.array([labels[s] for s in sids]))
    cnn = [_init(jax.random.key(i)) for i in range(2)]
    return x, sids, labels, waves, host, cnn


def _jax_run(user, path, mode):
    x, sids, labels, waves, host, cnn = user
    com = JaxCommittee(copy.deepcopy(host),
                       [JaxCNN(f"cnn.it_{i}", v, JAX_TINY, JAX_TC)
                        for i, v in enumerate(cnn)], JAX_TINY, JAX_TC)
    data = JaxUserData("u0", JaxPool(x, sids), labels,
                       store=JaxStore(waves, TINY.input_length))
    os.makedirs(path)
    return JaxLoop(JaxALConfig(queries=Q, epochs=EPOCHS, mode=mode,
                               seed=SEED, qbdc_k=4),
                   retrain_epochs=RETRAIN).run_user(com, data, path)


def _port_committee(user):
    _, _, _, _, host, cnn = user
    return Committee(
        convert.host_members_from_jax(copy.deepcopy(host)),
        [CNNMember(f"cnn.it_{i}", convert.cnn_variables_from_jax(
            v, TINY, "cpu"), TINY) for i, v in enumerate(cnn)],
        TINY, TC, device="cpu")


def _port_run(user, path, mode, *, epochs=EPOCHS, committee=None,
              ckpt_dtype="bfloat16"):
    x, sids, labels, waves, _, _ = user
    data = UserData("u0", FramePool(x, sids), labels,
                    store=DeviceWaveformStore(waves, TINY.input_length,
                                              "cpu"))
    os.makedirs(path, exist_ok=True)
    return ALLoop(ALConfig(queries=Q, epochs=epochs, mode=mode, seed=SEED,
                           qbdc_k=4, ckpt_dtype=ckpt_dtype),
                  retrain_epochs=RETRAIN, device="cpu").run_user(
        committee or _port_committee(user), data, path)


def _metrics(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for _, r in sorted({r["epoch"]: r for r in recs
                                  if "event" not in r}.items())]


def _state(path):
    with open(os.path.join(path, "al_state.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("mode", ["mc", "qbdc", "wmc"])
def test_loop_matches_jax(user, tmp_path, mode):
    jax_res = _jax_run(user, str(tmp_path / "jax"), mode)
    res = _port_run(user, str(tmp_path / "port"), mode)
    ours, theirs = _metrics(str(tmp_path / "port")), _metrics(
        str(tmp_path / "jax"))
    assert len(ours) == len(theirs) == EPOCHS + 1
    for a, b in zip(ours, theirs):
        assert a.get("queried") == b.get("queried")
        assert a["f1"][2:] == b["f1"][2:]  # host members: tolerance 0
        np.testing.assert_allclose(a["f1"][:2], b["f1"][:2], atol=1e-6)
    np.testing.assert_allclose(res["trajectory"], jax_res["trajectory"],
                               atol=1e-6)
    st, jst = _state(str(tmp_path / "port")), _state(str(tmp_path / "jax"))
    assert st["key_data"] == jst["key_data"]
    if mode == "wmc":
        assert st["member_weights"].keys() == jst["member_weights"].keys()
        for k, w in st["member_weights"].items():
            assert w == pytest.approx(jst["member_weights"][k], abs=1e-6)
    files = sorted(f for f in os.listdir(tmp_path / "port")
                   if f.startswith("classifier_"))
    assert files == ["classifier_cnn.cnn.it_0.npz",
                     "classifier_cnn.cnn.it_1.npz",
                     "classifier_gnb.gnb.it_0.npz",
                     "classifier_sgd.sgd.it_0.npz",
                     "classifier_xgb.xgb.it_0.npz"]


def test_killed_run_resumes_to_the_uninterrupted_state(user, tmp_path):
    whole = str(tmp_path / "whole")
    _port_run(user, whole, "mc", epochs=3, ckpt_dtype="float32")
    path = str(tmp_path / "killed")
    with faults.inject(faults.FaultRule("state.save", "kill", at=2)), \
            pytest.raises(faults.InjectedKill):
        _port_run(user, path, "mc", epochs=3, ckpt_dtype="float32")
    assert al_state.ALState.load(path).next_epoch == 0
    committee = workspace.load_committee(path, TINY, TC, device="cpu")
    assert [m.name for m in committee.cnn_members] == ["cnn.it_0",
                                                       "cnn.it_1"]
    _port_run(user, path, "mc", epochs=3, committee=committee,
              ckpt_dtype="float32")
    assert _metrics(path) == _metrics(whole)
    assert _state(path) == _state(whole)


@pytest.mark.parametrize("source", [
    "classifier_cnn.it_0.msgpack",  # the JAX committee's checkpoint name
    "classifier_cnn_res.it_0.msgpack",  # the JAX pre-trainer's fold name
])
def test_converted_res_workspace_resumes_with_one_file_a_member(
        user, tmp_path, source):
    """A JAX user workspace whose res member has either name, converted by
    ``workspace_from_jax``, resumes twice: each checkpoint replaces the
    file the member came from, so the committee keeps one CNN member."""
    jax_res = dataclasses.replace(JAX_TINY, arch="res")
    src = tmp_path / "jax"
    src.mkdir()
    JaxCNN("it_0", jax_cnn.init_variables(jax.random.key(3), jax_res),
           jax_res, JAX_TC).save(str(src / source))
    for m in user[4]:
        m.save(str(src / f"classifier_{m.kind}.{m.name}.pkl"))
    path = str(tmp_path / "port")
    convert.workspace_from_jax(str(src), path, TINY)
    cnn_files = [source.replace(".msgpack", ".npz")]
    for epochs in (1, 2, None):  # run one iteration, resume for one more
        assert sorted(f for f in os.listdir(path)
                      if f.startswith("classifier_cnn")) == cnn_files
        committee = workspace.load_committee(path, TINY, TC, device="cpu")
        assert [(m.name, m.config.arch) for m in committee.cnn_members] == [
            ("it_0", "res")]
        if epochs is not None:
            _port_run(user, path, "mc", epochs=epochs, committee=committee,
                      ckpt_dtype="float32")
    assert al_state.ALState.load(path).next_epoch == 2


@pytest.fixture(scope="module")
def cli_trees(tmp_path_factory, user):
    """A synthetic AMG tree with waveforms, a JAX registry of GaussianNB,
    SGD, GBDT pickles and one CNN ``.msgpack``, and its conversion."""
    root = tmp_path_factory.mktemp("cli_cnn")
    roots = build_synth_roots(root, np.random.default_rng(1987))
    npy = os.path.join(roots["amg"], "npy")
    os.makedirs(npy)
    rng = np.random.default_rng(5)
    for sid in range(201, 241):
        np.save(os.path.join(npy, f"{sid}.npy"),
                rng.standard_normal(9000).astype(np.float32))
    pre = os.path.join(roots["models"], "pretrained")
    os.makedirs(pre)
    x = rng.standard_normal((200, 8)).astype(np.float32)
    for m in _host_members(x, np.arange(200) % 4):
        m.save(os.path.join(pre, f"classifier_{m.kind}.{m.name}.pkl"))
    JaxCNN("cnn.it_0", user[5][0], JAX_TINY).save(
        os.path.join(pre, "classifier_cnn.cnn.it_0.msgpack"))
    port_models = str(root / "port_models")
    written = convert.registry_from_jax(
        pre, os.path.join(port_models, "pretrained"), TINY)
    assert sorted(written) == ["classifier_cnn.cnn.it_0.npz",
                               "classifier_gnb.gnb.it_0.npz",
                               "classifier_sgd.sgd.it_0.npz",
                               "classifier_xgb.xgb.it_0.npz"]
    return roots, port_models


AL = ["-q", "3", "-e", "2", "-n", "10", "--max-users", "1",
      "--retrain-epochs", "1", "--cnn-config-json", json.dumps(TINY_KW)]


@pytest.mark.parametrize("mode", ["mc", "qbdc"])
def test_cli_with_a_converted_registry_matches_the_jax_cli(cli_trees, mode):
    roots, port_models = cli_trees
    assert jax_amg_test.main(AL + ["-m", mode, "--models-root",
                                   roots["models"], "--amg-root",
                                   roots["amg"], "--device", "cpu"]) == 0
    assert amg_test.main(AL + ["-m", mode, "--models-root", port_models,
                               "--amg-root", roots["amg"],
                               "--device", "cpu"]) == 0
    (uid,) = os.listdir(os.path.join(port_models, "users"))
    ours = _metrics(os.path.join(port_models, "users", uid, mode))
    theirs = _metrics(os.path.join(roots["models"], "users", uid, mode))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.get("queried") == b.get("queried")
        assert a["f1"][1:] == b["f1"][1:]
        np.testing.assert_allclose(a["f1"][0], b["f1"][0], atol=1e-6)


def test_cli_refuses_qbdc_without_cnn_and_unported_files(cli_trees,
                                                         tmp_path, capsys):
    roots, port_models = cli_trees
    models = str(tmp_path / "models")
    shutil.copytree(os.path.join(port_models, "pretrained"),
                    os.path.join(models, "pretrained"))
    os.remove(os.path.join(models, "pretrained",
                           "classifier_cnn.cnn.it_0.npz"))
    flags = ["--models-root", models, "--amg-root", roots["amg"],
             "--device", "cpu"]
    assert amg_test.main(AL + ["-m", "qbdc"] + flags) == 1
    assert "needs pre-trained CNN members" in capsys.readouterr().out
    assert amg_test.main(AL + ["-m", "mc", "--cnn-arch", "res",
                               "--cnn-config-json", '{"arch": "vgg"}']
                         + flags) == 1
    assert "drop one of them" in capsys.readouterr().out
    assert amg_test.main(AL + ["-m", "mc", "--full-song-hop", "0"]
                         + flags) == 1
    assert "--full-song-hop must be" in capsys.readouterr().out
    open(os.path.join(models, "pretrained", "classifier_cnn.x.msgpack"),
         "wb").close()
    assert amg_test.main(AL + ["-m", "mc"] + flags) == 1
    assert "registry_from_jax" in capsys.readouterr().out
