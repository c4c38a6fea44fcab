"""The port's AL loop on a pool-axis mesh against its unmeshed run, on the
CPU (the counterpart of ``tests/test_sharded_loop.py``).

A mesh of CPU entries (``["cpu"] * 2``) stands where the JAX tests force
host devices.  Every reduction of a select is row-local and the candidate
merge is index-stable, so the meshed trajectories and queried songs equal
the unmeshed ones bit for bit (tolerance 0), for the host committee in
every mode, for a CNN committee whose forward splits its crop rows, and
for a retrain spread over a member axis of 2 and 4 (5 members, each
fitted once).
The pad width is shard-divisible; a fleet cohort on a mesh stacks one
``_dispatch_scores`` round into one sharded dispatch whose rows are the
users' own meshed calls; ``amg_test --device cpu --mesh 2`` selects what
the unmeshed CLI selects."""

import json
import os

import numpy as np
import pytest
import torch

from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.al import state as al_state
from consensus_entropy_tpu_torch.al.acquisition import Acquirer
from consensus_entropy_tpu_torch.al.loop import ALLoop, UserData
from consensus_entropy_tpu_torch.config import ALConfig, CNNConfig, TrainConfig
from consensus_entropy_tpu_torch.data.audio import DeviceWaveformStore
from consensus_entropy_tpu_torch.models import short_cnn
from consensus_entropy_tpu_torch.models.committee import (
    CNNMember,
    Committee,
    FramePool,
)
from consensus_entropy_tpu_torch.models.members import GNBMember, SGDMember
from consensus_entropy_tpu_torch.parallel import (
    ShardedRows,
    make_pool_mesh,
    make_training_mesh,
)

torch.set_num_threads(1)

TINY = CNNConfig(n_channels=4, n_mels=32, n_layers=5, input_length=8192)
MODES = ["mc", "hc", "mix", "rand", "wmc"]


def _user_data(seed=3, n_songs=24, f=10, waves=False):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4, f)).astype(np.float32) * 2.0
    rows, sids, labels = [], [], {}
    for i in range(n_songs):
        sid = f"song{i:03d}"
        c = int(rng.integers(0, 4))
        labels[sid] = c
        k = int(rng.integers(3, 7))
        rows.append(centers[c]
                    + rng.standard_normal((k, f)).astype(np.float32))
        sids += [sid] * k
    pool = FramePool(np.vstack(rows), sids)
    counts = rng.integers(1, 30, size=(n_songs, 4))
    hc = np.round(counts / counts.sum(1, keepdims=True), 3).astype(
        np.float32)
    store = None
    if waves:
        store = DeviceWaveformStore(
            {s: rng.standard_normal(9000).astype(np.float32)
             for s in pool.song_ids}, TINY.input_length, "cpu")
    return UserData("u0", pool, labels, hc_rows=hc, store=store)


def _host_members(seed=7, f=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((60, f)).astype(np.float32)
    y = np.tile(np.arange(4), 15)
    return [GNBMember("gnb").fit(x, y), SGDMember("sgd", seed=0).fit(x, y)]


def _run(path, mode, *, mesh=None, train_mesh=None, pad_to=None, cnn=0,
         n_songs=24, epochs=3, queries=4):
    path.mkdir(parents=True, exist_ok=True)
    data = _user_data(3, n_songs=n_songs, waves=bool(cnn))
    cnns = [CNNMember(f"cnn{i}", short_cnn.init_variables(
        prng.key(i, "cpu"), TINY, "cpu"), TINY) for i in range(cnn)]
    com = Committee(_host_members(), cnns, TINY, TrainConfig(batch_size=2),
                    device="cpu", mesh=mesh, train_mesh=train_mesh)
    loop = ALLoop(ALConfig(queries=queries, epochs=epochs, mode=mode,
                           seed=11),
                  pad_pool_to=pad_to, retrain_epochs=1 if cnn else None,
                  device="cpu", mesh=mesh)
    res = loop.run_user(com, data, str(path))
    return res["trajectory"], al_state.ALState.load(str(path)).queried


@pytest.mark.parametrize("mode", MODES)
def test_sharded_loop_bitwise_matches_single_device(tmp_path, mode):
    ref = _run(tmp_path / "ref", mode)
    got = _run(tmp_path / "mesh", mode, mesh=make_pool_mesh(["cpu"] * 2))
    assert got == ref


def test_sharded_cnn_loop_matches_single_device(tmp_path):
    """Two CNN members: the crop rows of each bucket split over the mesh,
    the scores gathered; the trajectory is the unmeshed one."""
    ref = _run(tmp_path / "ref", "mc", cnn=2, epochs=2)
    got = _run(tmp_path / "mesh", "mc", cnn=2, epochs=2,
               mesh=make_pool_mesh(["cpu"] * 2))
    assert got == ref


@pytest.mark.parametrize("member", [2, 4])
def test_member_sharded_retrain_loop_matches_single_device(tmp_path,
                                                           member):
    """Five CNN members on a member axis of 2 and of 4 (contiguous
    blocks of 3 and 2 members a device, no padding trained): the
    retrained committee and the trajectory are the unmeshed ones."""
    ref = _run(tmp_path / "ref", "mc", cnn=5, epochs=2)
    tm = make_training_mesh(dp=1, member=member, devices=["cpu"] * member)
    got = _run(tmp_path / "mesh", "mc", cnn=5, epochs=2, train_mesh=tm)
    assert got == ref


def test_fit_many_pads_members_with_distinct_keys(monkeypatch):
    """``fit_many(mesh=)`` fits each of the committee's members once,
    under its own key stream, on its member-axis device (the JAX
    package's padding slots are not trained), and returns exactly the
    committee's members, each equal to its unmeshed fit."""
    rng = np.random.default_rng(5)
    ids = [f"s{i}" for i in range(6)]
    store = DeviceWaveformStore(
        {s: rng.standard_normal(9000).astype(np.float32) for s in ids},
        TINY.input_length, "cpu")
    y = np.eye(4, dtype=np.float32)[[0, 1, 2, 3, 0, 1]]
    members = [short_cnn.init_variables(prng.key(i, "cpu"), TINY, "cpu")
               for i in range(3)]
    com = Committee([], [CNNMember(f"c{i}", v, TINY)
                         for i, v in enumerate(members)], TINY,
                    TrainConfig(batch_size=2), device="cpu")
    key = prng.key(9, "cpu")
    args = (store, ids[:4], y[:4], ids[4:], y[4:], key)
    ref_best, ref_hist = com.trainer.fit_many(members, *args, n_epochs=1)
    tm = make_training_mesh(dp=1, member=2, devices=["cpu"] * 2)
    fit, keys = com.trainer.fit, []

    def counted(variables, store, *rest, **kw):
        keys.append(rest[4].tolist())
        return fit(variables, store, *rest, **kw)

    monkeypatch.setattr(com.trainer, "fit", counted)
    best, hist = com.trainer.fit_many(members, *args, n_epochs=1, mesh=tm)
    assert keys == [prng.fold_in(key, i).tolist() for i in range(3)]
    assert len(best) == len(hist) == 3
    assert hist == ref_hist
    for b, r in zip(best, ref_best):
        for k in r:
            assert torch.equal(b[k], r[k]), k


def test_pad_pool_to_does_not_change_selection(tmp_path):
    ref = _run(tmp_path / "ref", "mc")
    got = _run(tmp_path / "pad", "mc", pad_to=40,
               mesh=make_pool_mesh(["cpu"] * 2))
    assert got == ref


@pytest.mark.parametrize("n_dev", [2, 4])
def test_mesh_pad_width_is_shard_divisible(n_dev):
    """The pad is the lcm of ``pad_multiple`` and the pool axis: 22 songs
    pad to 24 on 2 and 4 shards, and 30 songs to 32 on 4; the device twins
    and the probs buffer split into equal blocks."""
    songs = [f"s{i}" for i in range(22)]
    mesh = make_pool_mesh(["cpu"] * n_dev)
    acq = Acquirer(songs, None, queries=3, mode="mc", mesh=mesh,
                   pad_multiple=6)
    assert acq.n_pad % n_dev == 0 and acq.n_pad % 6 == 0
    assert acq.n_pad == 24
    probs = np.random.default_rng(0).uniform(
        0.01, 1, (2, 22, 4)).astype(np.float32)
    acq.select(probs)
    d = acq.device
    assert isinstance(d.pool_mask, ShardedRows)
    assert [b.shape[0] for b in d.pool_mask.blocks] == [24 // n_dev] * n_dev
    assert [b.shape for b in d.probs.blocks] == [(2, 24 // n_dev, 4)] * n_dev


def test_fleet_cohort_on_a_mesh_stacks_one_round(tmp_path):
    """Three meshed acquirers' fused mc steps in ONE dispatch round: one
    stacked sharded dispatch whose rows (values, indices, gathered
    entropy, masks) are each acquirer's own meshed call, its masks copied
    back into each session's sharded twins."""
    import types

    from consensus_entropy_tpu_torch.fleet import FleetScheduler
    from consensus_entropy_tpu_torch.fleet.session import ScoreStep

    rng = np.random.default_rng(3)
    songs = [f"s{i}" for i in range(24)]
    mesh = make_pool_mesh(["cpu"] * 2)
    sched = FleetScheduler(ALConfig(queries=4, epochs=1, mode="mc"),
                           mesh=mesh)
    sched.open(3)
    try:
        work = []
        for i in range(3):
            probs = rng.uniform(0.01, 1, (2, 24, 4)).astype(np.float32)
            fleet_acq, own_acq = (Acquirer(songs, None, queries=4,
                                           mode="mc", mesh=mesh)
                                  for _ in range(2))
            fn_key, inputs = fleet_acq.scoring_inputs(probs)
            state = types.SimpleNamespace(
                n_pad=fleet_acq.n_pad,
                entry=types.SimpleNamespace(user_id=f"u{i}"))
            step = ScoreStep(types.SimpleNamespace(acq=fleet_acq), fn_key,
                             inputs)
            own = own_acq.run_scoring(*own_acq.scoring_inputs(probs))
            work.append((state, step, own))
        rows = dict((id(st), res) for st, res in sched._dispatch_scores(
            [(st, step) for st, step, _ in work]))
    finally:
        sched.close()
    assert [(d["fn"], d["batch"]) for d in sched.report.dispatches] \
        == [("mc_fused", 3)]
    for st, step, own in work:
        res = rows[id(st)]
        assert res.pool_mask is step.inputs[1]
        for got, ref in zip(res, own):
            if ref is None:
                assert got is None
                continue
            if isinstance(ref, ShardedRows):
                got, ref = got.full(), ref.full()
            assert torch.equal(got, ref)


def _registry(models, n_feat, rng):
    """A GaussianNB + SGD registry of the port's member files, fitted on
    noisy random frames."""
    pre = os.path.join(models, "pretrained")
    os.makedirs(pre)
    x = rng.standard_normal((80, n_feat)).astype(np.float32)
    y = np.tile(np.arange(4), 20)
    for m in (GNBMember("gnb.it_0").fit(x, y),
              SGDMember("sgd.it_0", seed=0).fit(x, y)):
        m.save(os.path.join(pre, Committee.member_file(m)))


def test_amg_test_mesh_selects_what_the_unmeshed_cli_selects(tmp_path):
    """``--mesh 2`` on the CPU: each user's queried songs and F1s equal
    the unmeshed CLI's (tolerance 0)."""
    from consensus_entropy_tpu_torch.cli import amg_test
    from tests.synth_data import FEATURE_COLS, build_synth_roots

    rng = np.random.default_rng(1987)
    roots = build_synth_roots(tmp_path, rng)
    runs = {}
    for tag, extra in (("plain", []), ("mesh", ["--mesh", "2"])):
        models = str(tmp_path / tag)
        _registry(models, len(FEATURE_COLS), np.random.default_rng(4))
        assert amg_test.main(["-q", "3", "-e", "2", "-m", "mc", "-n", "10",
                              "--max-users", "2", "--models-root", models,
                              "--amg-root", roots["amg"], "--device", "cpu",
                              *extra]) == 0
        users = os.path.join(models, "users")
        runs[tag] = {}
        for u in sorted(os.listdir(users)):
            with open(os.path.join(users, u, "mc", "metrics.jsonl")) as f:
                runs[tag][u] = [json.loads(line) for line in f]
    assert len(runs["plain"]) == 2 and runs["mesh"] == runs["plain"]


@pytest.mark.parametrize("extra", [
    ["--distributed", "bad"],
    ["--distributed", "127.0.0.1:1,1,0"],
    ["--distributed", "127.0.0.1:1,1,0", "--mesh", "2"],
    ["--fleet", "2", "--distributed", "127.0.0.1:1,1,0", "--mesh", "auto"],
    ["--fleet", "2", "--mesh", "auto"],
], ids=["malformed", "no-mesh", "numeric-mesh", "fleet-distributed",
        "fleet-auto"])
def test_mesh_flag_errors_are_the_jax_clis(tmp_path, capsys, extra):
    """``--distributed`` is checked before any device query and needs
    ``--mesh auto``; the fleet takes an explicit mesh width and one
    process: each refusal prints the JAX CLI's message and exits 1."""
    from consensus_entropy_tpu.cli import amg_test as jax_amg_test
    from consensus_entropy_tpu_torch.cli import amg_test

    args = ["-q", "3", "-e", "2", "-m", "mc", "-n", "10", "--models-root",
            str(tmp_path), "--amg-root", str(tmp_path), "--device", "cpu"]
    assert jax_amg_test.main(args + extra) == 1
    theirs = capsys.readouterr().out
    assert amg_test.main(args + extra) == 1
    assert capsys.readouterr().out == theirs
    assert "--" in theirs


def test_qbdc_and_bad_mesh_are_refused(tmp_path, capsys):
    from consensus_entropy_tpu_torch.cli import amg_test

    pre = tmp_path / "pretrained"
    pre.mkdir()
    (pre / "classifier_cnn.c.it_0.npz").write_bytes(b"")
    base = ["-q", "3", "-e", "2", "-n", "10", "--models-root",
            str(tmp_path), "--amg-root", str(tmp_path), "--device", "cpu"]
    assert amg_test.main(base + ["-m", "qbdc", "--mesh", "2"]) == 1
    assert "qbdc does not support --mesh" in capsys.readouterr().out
    from consensus_entropy_tpu_torch.cli.amg_test import _meshes

    class Args:
        mesh, fleet, distributed = "cuda:0,cuda:0", None, None

    assert _meshes(Args, torch.device("cpu"), None) is None
    assert "device list" in capsys.readouterr().out
    Args.mesh = "cpu,cpu,cpu"
    mesh, train_mesh = _meshes(Args, torch.device("cpu"), None)
    assert mesh.shape == {"pool": 3} and train_mesh is None
