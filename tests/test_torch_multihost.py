"""``parallel.multihost`` over ``torch.distributed``, on the CPU.

In one process ``initialize()`` does nothing and every helper is the
single-controller path; ``host_pool_slice`` covers every row, as the JAX
function's arithmetic does.  Then 2 and 4 gloo processes (spawned, an
explicit free ``tcp://127.0.0.1`` port, a time limit per run), each with a
mesh of two CPU entries over its own rows:

- feeding a host-complete array leaves each rank only its rows, at their
  global offsets, and ``gather_to_host`` gives the whole array back on
  every rank;
- ``broadcast_flag`` agrees on the coordinator's value;
- ``sync`` fires its ``multihost.sync`` fault point on the way in (every
  rank raises at the same hit, before the barrier) and the group still
  meets at the next barrier;
- a sharded select over ranks (mc, mix with its gathered entropy, rand,
  the fused mc's mask, and B2's ``linear_score_mc`` plain path) equals the
  one-process unsharded select: ids, values and masks bit-equal.

Then the main path over 2 and 3 gloo processes, each rank's mesh two CPU
entries: the acquirer's pad width counts the processes and its probs
buffer lies where its masks lie; ``ALLoop`` in every mode, and with a CNN
committee whose retrain spreads its members over every rank's member
axis, gives every rank the unmeshed trajectory and queried songs bit for
bit; ``amg_test --mesh auto --distributed`` selects what the unmeshed CLI
selects."""

import json
import os
import pathlib
import pickle
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from consensus_entropy_tpu_torch import convert, prng
from consensus_entropy_tpu_torch.kernels import linear_mc
from consensus_entropy_tpu_torch.ops import scoring
from consensus_entropy_tpu_torch.parallel import multihost, pool_mesh
from consensus_entropy_tpu_torch.parallel import sharding
from consensus_entropy_tpu_torch.parallel.mesh import (
    ShardedRows,
    make_training_mesh,
)
from consensus_entropy_tpu_torch.resilience import faults
from consensus_entropy_tpu_torch.resilience.faults import FaultRule

torch.set_num_threads(1)

M, N, C, K, SEED = 3, 32, 4, 5, 8
TIME_LIMIT_S = 120


def _problem():
    rng = np.random.default_rng(SEED)
    p = rng.uniform(0.01, 1, (M, N, C)).astype(np.float32)
    p[:, [9, 17, 30]] = p[:, [2]]          # ties across ranks
    x = rng.standard_normal((N, 2, 6)).astype(np.float32)
    x[[20, 28]] = x[3]
    w = (rng.standard_normal((M, 6, C)) / 3).astype(np.float32)
    b = (rng.standard_normal((M, C)) * 0.1).astype(np.float32)
    return {"probs": p, "pool_mask": rng.uniform(size=N) > 0.2,
            "hc_freq": rng.uniform(0, 1, (N, C)).astype(np.float32),
            "hc_mask": rng.uniform(size=N) > 0.3, "x": x, "w": w, "b": b}


def _select(res) -> dict:
    ent = res.entropy
    if isinstance(ent, ShardedRows):
        ent = multihost.gather_to_host(ent)
    out = {"values": res.values.numpy(), "indices": res.indices.numpy(),
           "entropy": np.asarray(ent)}
    if isinstance(res, scoring.FusedStepResult):
        out["pool_mask"] = multihost.gather_to_host(res.pool_mask)
    return out


def _cases(rank: int, world: int) -> dict:
    out = {}
    prob = _problem()
    mesh = multihost.global_pool_mesh(["cpu"] * 2)
    # feed and gather
    fed = multihost.feed_pool_axis(prob["probs"], mesh, 1)
    per = N // world
    out["offsets"] = fed.offsets
    out["local_rows"] = [b.shape[1] for b in fed.blocks]
    out["gathered"] = multihost.gather_to_host(fed)
    # the coordinator's flag
    out["flags"] = [multihost.broadcast_flag(rank == 0),
                    multihost.broadcast_flag(rank != 0)]
    # sync's fault point: hit 2 raises on every rank before its barrier
    fired = []
    with faults.inject(FaultRule("multihost.sync", "raise", at=2)) as inj:
        for name in ("a", "b", "c"):
            try:
                multihost.sync(name)
            except faults.InjectedFault:
                fired.append(name)
    out["sync_fired"] = fired
    out["sync_hits"] = [f["barrier"] for f in inj.fired]
    # sharded selects over the ranks
    fns = pool_mesh.make_sharded_step_fns(mesh, k=K)
    probs = multihost.feed_pool_axis(prob["probs"], mesh, 1)
    mask = multihost.feed_pool_axis(prob["pool_mask"], mesh, 0)
    hc = multihost.feed_pool_axis(prob["hc_freq"], mesh, 0)
    hc_mask = multihost.feed_pool_axis(prob["hc_mask"], mesh, 0)
    out["mc"] = _select(fns["mc"](probs, mask))
    out["mix"] = _select(fns["mix"](probs, mask, hc, hc_mask))
    out["rand"] = _select(fns["rand"](prng.key(3, "cpu"), mask))
    out["mc_fused"] = _select(fns["mc_fused"](probs, mask))
    w_p, b_p = convert.linear_members_from_jax(prob["w"], prob["b"],
                                               device="cpu")
    b2 = sharding.make_shardmap_pallas_mc_scorer(mesh, n_members=M, k=K)
    out["b2"] = _select(b2(multihost.feed_pool_axis(prob["x"], mesh, 0),
                           w_p, b_p, multihost.feed_pool_axis(
                               prob["pool_mask"], mesh, 0)))
    out["per"] = per
    return out


def _worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        result = _cases(rank, world)
    finally:
        multihost.shutdown()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(target, world: int, out_dir: str, *extra) -> list:
    """``target(rank, world, *extra, out_dir)`` in ``world`` spawned
    processes; each rank's pickled result, in rank order."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, *extra, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIME_LIMIT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def runs(request, tmp_path_factory):
    """Every case in ``world`` gloo processes: one result dict a rank."""
    world = request.param
    out_dir = str(tmp_path_factory.mktemp(f"world{world}"))
    return world, _spawn(_worker, world, out_dir, _free_port())


# -- the main path over ranks ------------------------------------------------

LOOP_MODES = ["mc", "hc", "mix", "rand", "wmc", "cnn"]
AMG_ARGS = ["-q", "3", "-e", "2", "-m", "mc", "-n", "10", "--max-users",
            "2", "--device", "cpu"]


def _loop(path, mode, **kw):
    from tests.test_torch_sharded_loop import _run

    if mode == "cnn":
        return _run(path, "mc", cnn=3, epochs=2, **kw)
    return _run(path, mode, **kw)


def _amg_metrics(models) -> dict:
    users = os.path.join(models, "users")
    out = {}
    for u in sorted(os.listdir(users)):
        with open(os.path.join(users, u, "mc", "metrics.jsonl")) as f:
            out[u] = [json.loads(line) for line in f]
    return out


def _loop_worker(rank, world, port, root, out_dir):
    """One rank of the main path: the acquirer's layout, ``ALLoop`` in
    every mode (all ranks in one workspace, which the coordinator
    writes), then ``amg_test --distributed`` as its own process group."""
    from consensus_entropy_tpu_torch.al import workspace
    from consensus_entropy_tpu_torch.al.acquisition import Acquirer
    from consensus_entropy_tpu_torch.cli import amg_test

    torch.set_num_threads(1)
    root = pathlib.Path(root)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        mesh = multihost.global_pool_mesh(["cpu"] * 2)
        out = {}
        acq = Acquirer([f"s{i}" for i in range(22)], None, queries=3,
                       mode="mc", mesh=mesh)
        probs = np.random.default_rng(0).uniform(
            0.01, 1, (2, 22, 4)).astype(np.float32)
        out["pad"] = {"n_pad": acq.n_pad, "ids": acq.select(probs),
                      "probs": (acq.device.probs.offsets,
                                acq.device.probs.blocks[0].shape[1]),
                      "mask": (acq.device.pool_mask.offsets,
                               acq.device.pool_mask.blocks[0].shape[0])}
        tm = make_training_mesh(dp=1, member=2, devices=["cpu"] * 2)
        for mode in LOOP_MODES:
            out[mode] = _loop(root / mode, mode, mesh=mesh,
                              train_mesh=tm if mode == "cnn" else None)
        # the CLI's own group: a port the coordinator finds free just now
        cli_port = int(multihost.broadcast_tensor(
            torch.tensor([_free_port() if rank == 0 else 0])))
    finally:
        multihost.shutdown()
    if rank:
        # the other ranks load each user's committee a second late: the
        # coordinator's session would commit its first checkpoint before
        # they read the resume state, unless the session waits for them
        load = workspace.load_committee

        def late(*args, **kw):
            time.sleep(1.0)
            return load(*args, **kw)

        workspace.load_committee = late
    try:
        out["cli_rc"] = amg_test.main(AMG_ARGS + [
            "--models-root", str(root / "models"), "--amg-root",
            str(root / "amg"), "--mesh", "auto", "--distributed",
            f"127.0.0.1:{cli_port},{world},{rank}"])
    finally:
        multihost.shutdown()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def synth_roots(tmp_path_factory):
    from tests.synth_data import build_synth_roots

    root = tmp_path_factory.mktemp("synth")
    return build_synth_roots(root, np.random.default_rng(1987))


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def loop_runs(request, tmp_path_factory, synth_roots):
    """The main path in ``world`` gloo processes: each rank's results and
    the workspace the coordinator wrote."""
    from tests.synth_data import FEATURE_COLS
    from tests.test_torch_sharded_loop import _registry

    world = request.param
    root = tmp_path_factory.mktemp(f"loop{world}")
    os.symlink(synth_roots["amg"], root / "amg")
    _registry(str(root / "models"), len(FEATURE_COLS),
              np.random.default_rng(4))
    out_dir = str(tmp_path_factory.mktemp(f"loop{world}_out"))
    results = _spawn(_loop_worker, world, out_dir, _free_port(), str(root))
    return world, root, results


def test_acquirer_pad_counts_the_processes(loop_runs):
    """22 songs pad to a multiple of 8 and of 2 shards times the
    processes (24 for 2 and 3); each rank's probs buffer holds the rows
    its masks hold, and the select is the unmeshed one."""
    from consensus_entropy_tpu_torch.al.acquisition import Acquirer

    world, _, results = loop_runs
    ref = Acquirer([f"s{i}" for i in range(22)], None, queries=3,
                   mode="mc", device="cpu")
    probs = np.random.default_rng(0).uniform(
        0.01, 1, (2, 22, 4)).astype(np.float32)
    want = ref.select(probs)
    for rank, r in enumerate(results):
        pad = r["pad"]
        assert pad["n_pad"] == 24 and pad["n_pad"] % (2 * world) == 0
        per = 24 // world // 2
        assert pad["mask"] == ((rank * 2 * per, (rank * 2 + 1) * per), per)
        assert pad["probs"] == pad["mask"]
        assert pad["ids"] == want


@pytest.mark.parametrize("mode", LOOP_MODES)
def test_loop_over_ranks_is_the_unmeshed_loop(loop_runs, tmp_path, mode):
    """Every rank's trajectory and queried songs equal the one-process
    unmeshed run's, bit for bit; the cnn case retrains 3 members over a
    member axis of 2 a rank, each member trained once by its owner."""
    _, _, results = loop_runs
    ref = _loop(tmp_path / "ref", mode)
    for r in results:
        assert r[mode] == ref


def test_amg_test_distributed_selects_what_the_unmeshed_cli_selects(
        loop_runs, tmp_path):
    """``amg_test --mesh auto --distributed COORD,N,ID`` in every rank,
    the ranks other than the coordinator loading each user's committee a
    second late: each exits 0, and the coordinator's workspace holds the
    unmeshed CLI's queried songs and F1s for every user (tolerance 0)."""
    from consensus_entropy_tpu_torch.cli import amg_test
    from tests.synth_data import FEATURE_COLS
    from tests.test_torch_sharded_loop import _registry

    _, root, results = loop_runs
    assert [r["cli_rc"] for r in results] == [0] * len(results)
    models = str(tmp_path / "plain")
    _registry(models, len(FEATURE_COLS), np.random.default_rng(4))
    assert amg_test.main(AMG_ARGS + ["--models-root", models,
                                     "--amg-root", str(root / "amg")]) == 0
    want = _amg_metrics(models)
    assert len(want) == 2
    assert _amg_metrics(str(root / "models")) == want


def test_initialize_without_arguments_does_nothing():
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1 and multihost.is_coordinator()
    assert multihost.broadcast_flag(True) is True
    multihost.sync("alone")
    t = torch.arange(6)
    assert multihost.gather_ranks(t) is t
    assert multihost.broadcast_tensor(t) is t


def test_host_pool_slice_covers_every_row(monkeypatch):
    from consensus_entropy_tpu.parallel import multihost as jax_multihost

    assert multihost.host_pool_slice(16) == jax_multihost.host_pool_slice(
        16) == slice(0, 16)
    for world in (2, 4, 8):
        monkeypatch.setattr(multihost, "process_count", lambda w=world: w)
        rows = []
        for r in range(world):
            monkeypatch.setattr(multihost, "process_index", lambda r=r: r)
            rows.extend(range(64)[multihost.host_pool_slice(64)])
        assert rows == list(range(64))
        with pytest.raises(ValueError, match="not divisible"):
            multihost.host_pool_slice(64 + 1)


def test_one_process_feed_is_the_single_controller_split():
    from consensus_entropy_tpu_torch.parallel.mesh import make_pool_mesh

    x = np.arange(24, dtype=np.float32).reshape(2, 12)
    mesh = make_pool_mesh(["cpu"] * 3)
    fed = multihost.feed_pool_axis(x, mesh, 1)
    ref = ShardedRows.split(torch.from_numpy(x), mesh.device_list, 1)
    assert fed.offsets == ref.offsets == (0, 4, 8) and fed.n == 12
    np.testing.assert_array_equal(multihost.gather_to_host(fed), x)
    assert multihost.feed_replicated({"a": [x]}, mesh)["a"][0].shape \
        == (2, 12)


def test_feed_and_gather_round_trip(runs):
    world, results = runs
    prob = _problem()
    per = N // world
    for rank, res in enumerate(results):
        assert res["offsets"] == (rank * per, rank * per + per // 2)
        assert res["local_rows"] == [per // 2] * 2
        np.testing.assert_array_equal(res["gathered"], prob["probs"])


def test_broadcast_flag(runs):
    _, results = runs
    assert [r["flags"] for r in results] == [[True, False]] * len(results)


def test_sync_fires_its_fault_point(runs):
    _, results = runs
    for r in results:
        assert r["sync_fired"] == ["b"]
        assert r["sync_hits"] == ["b"]


def test_sharded_select_over_ranks_is_the_one_process_select(runs):
    _, results = runs
    prob = _problem()
    t = {k: torch.from_numpy(v) for k, v in prob.items()}
    plain = scoring.make_scoring_fns(k=K)
    w_p, b_p = convert.linear_members_from_jax(prob["w"], prob["b"],
                                               device="cpu")
    refs = {
        "mc": plain["mc"](t["probs"], t["pool_mask"]),
        "mix": plain["mix"](t["probs"], t["pool_mask"], t["hc_freq"],
                            t["hc_mask"]),
        "rand": plain["rand"](prng.key(3, "cpu"), t["pool_mask"]),
        "mc_fused": plain["mc_fused"](t["probs"], t["pool_mask"].clone()),
        "b2": scoring.ScoreResult(*linear_mc.linear_score_mc(
            t["x"], w_p, b_p, t["pool_mask"], n_members=M, k=K,
            fuse_topk=True)),
    }
    for key, ref in refs.items():
        want = _select(ref)
        for r in results:
            got = r[key]
            live = want["values"] > -np.inf
            np.testing.assert_array_equal(got["values"], want["values"])
            np.testing.assert_array_equal(got["indices"][live],
                                          want["indices"][live])
            np.testing.assert_array_equal(got["entropy"], want["entropy"])
            if "pool_mask" in want:
                np.testing.assert_array_equal(got["pool_mask"],
                                              want["pool_mask"])
