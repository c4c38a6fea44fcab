"""The plain reference against the port at a tiny size on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import check, inputs
from benchmark.reference import host, prng, select, train, trunk

TINY = dict(n_channels=4, sample_rate=4000, n_fft=64, hop_length=32,
            f_max=2000.0, n_mels=16, n_layers=3, input_length=2048)


def _configs(arch):
    from consensus_entropy_tpu_torch.config import CNNConfig

    tcfg = trunk.TrunkConfig(arch=arch, **TINY)
    names = {f.name for f in dataclasses.fields(CNNConfig)}
    return tcfg, CNNConfig(**{k: v for k, v in dataclasses.asdict(
        tcfg).items() if k in names})


def test_prng_is_the_ports():
    from consensus_entropy_tpu_torch import prng as port

    for seed in (0, 7, 2 ** 31 + 5):
        k, pk = prng.key(seed), port.key(seed, "cpu")
        assert np.array_equal(k, pk.numpy())
        assert np.array_equal(prng.split(k, 4), port.split(pk, 4).numpy())
        assert np.array_equal(prng.fold_in(k, 3), port.fold_in(pk, 3).numpy())
        assert np.array_equal(prng.fold_in_static(k, "Dropout_0", 1),
                              port.fold_in_static(pk, "Dropout_0",
                                                  1).numpy())
        assert np.array_equal(prng.uniform(k, 300),
                              port.uniform(pk, (300,)).numpy())
        assert np.array_equal(prng.bernoulli(k, 0.5, 64),
                              port.bernoulli(pk, 0.5, (64,)).numpy())
        assert np.array_equal(prng.permutation(k, 37),
                              port.permutation(pk, 37).numpy())


@pytest.mark.parametrize("arch", ["vgg", "res"])
def test_trunk_is_the_ports(arch):
    from consensus_entropy_tpu_torch import prng as port
    from consensus_entropy_tpu_torch.models import short_cnn

    tcfg, cfg = _configs(arch)
    gen = torch.Generator().manual_seed(3)
    v = inputs.cnn_variables(tcfg, 1, gen, "cpu")[0]
    assert list(v) == list(short_cnn.variable_shapes(cfg))
    x = torch.randn((6, tcfg.input_length), generator=gen) * 0.1
    torch.testing.assert_close(trunk.infer(v, x, tcfg),
                               short_cnn.apply_infer(v, x, cfg),
                               rtol=1e-6, atol=1e-7)
    key = prng.key(11)
    keep = prng.bernoulli(prng.fold_in_static(key, "Dropout_0", 1), 0.5,
                          6 * tcfg.widths[-1]).reshape(6, -1)
    got, stats = trunk.forward(v, x, tcfg, train=True,
                               drop_keep=torch.as_tensor(keep))
    want, want_stats = short_cnn.apply_train(v, x, port.key(11, "cpu"), cfg)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    for k in want_stats:
        torch.testing.assert_close(stats[k], want_stats[k])


def test_retrain_is_the_ports():
    from consensus_entropy_tpu_torch import prng as port
    from consensus_entropy_tpu_torch.config import TrainConfig
    from consensus_entropy_tpu_torch.data.audio import DeviceWaveformStore
    from consensus_entropy_tpu_torch.models.cnn_trainer import CNNTrainer

    tcfg, cfg = _configs("vgg")
    gen = torch.Generator().manual_seed(5)
    data = torch.randn((12, 3000), generator=gen) * 0.1
    store = DeviceWaveformStore.from_padded(
        list(range(1, 13)), data, torch.full((12,), 3000),
        tcfg.input_length)
    v = inputs.cnn_variables(tcfg, 1, gen, "cpu")[0]
    rng = np.random.default_rng(0)
    y_tr = check._one_hot(rng.integers(0, 4, 7), 4)
    y_te = check._one_hot(rng.integers(0, 4, 4), 4)
    tr, te = [3, 1, 4, 9, 5, 2, 6], [7, 8, 10, 11]
    best, _ = CNNTrainer(cfg, TrainConfig()).fit(
        v, store, tr, y_tr, te, y_te, port.key(21, "cpu"), n_epochs=3)
    lengths = np.full(12, 3000)
    traj = []
    ref, grads = train.fit(v, data, lengths, [s - 1 for s in tr], y_tr,
                           [s - 1 for s in te], y_te, prng.key(21), tcfg,
                           n_epochs=3, trajectory=traj)
    assert len(traj) == 3 and set(grads) <= set(v)
    for k in v:
        torch.testing.assert_close(ref[k], best[k], rtol=1e-5, atol=1e-7)
    best_epoch = 1 + max(range(3), key=lambda e: traj[e][0])
    assert check.nearest_epoch(v, best, traj, grads) == (best_epoch, 0.0,
                                                         True)
    # a retrain left unchanged reads 1, one on half of each batch far off
    assert check.nearest_epoch(v, v, traj, grads)[:2] == (0, 1.0)
    half, _ = train.fit(v, data, lengths, [s - 1 for s in tr], y_tr,
                        [s - 1 for s in te], y_te, prng.key(21), tcfg,
                        n_epochs=3, half_batch=True)
    assert check.nearest_epoch(v, half, traj, grads)[1] > 1e-2
    # a fixed epoch kept by every member reads 1, a start kept by all too
    assert check.retrain_numbers([(1, 0.0, True), (1, 0.3, True)]) == (
        0.0, 1.0)
    assert check.retrain_numbers([(2, 0.5, True), (1, 0.2, True)]) == (
        0.2, 0.5)
    assert check.retrain_numbers([(0, 1.0, True), (0, 1.0, True)]) == (
        1.0, 1.0)
    # a member whose reference kept its start says nothing of the retrain
    assert check.retrain_numbers([(0, 0.0, False), (2, 0.4, True)]) == (
        0.4, 1.0)
    assert check.retrain_numbers([(0, 0.0, False)] * 2) == (0.0, 0.0)


def _host_members():
    from consensus_entropy_tpu_torch.models.gbdt import NativeGBDTMember
    from consensus_entropy_tpu_torch.models.members import (
        GNBMember,
        SGDMember,
    )

    rng = np.random.default_rng(1)
    centers = rng.normal(0, 0.5, (4, 12)).astype(np.float32)
    x, y = inputs.labelled_rows(rng, centers, 200)
    members = [GNBMember("g").fit(x, y), SGDMember("s", seed=0).fit(x, y),
               NativeGBDTMember("x").fit(x, y)]
    return members, centers, rng


def test_host_predictions_are_the_ports():
    members, centers, rng = _host_members()
    xq, yq = inputs.labelled_rows(rng, centers, 30)
    for m in members:
        st = check.host_state(m)
        np.testing.assert_allclose(host.member_proba(st, xq, 4),
                                   m.predict_proba(xq), rtol=1e-5,
                                   atol=1e-6)
        assert np.array_equal(host.member_predict(st, xq, 4),
                              m.predict(xq))


def test_host_fits_and_updates_are_the_ports():
    from consensus_entropy_tpu_torch.models.gbdt import NativeGBDTMember
    from consensus_entropy_tpu_torch.models.members import (
        GNBMember,
        SGDMember,
    )

    rng = np.random.default_rng(4)
    centers = rng.normal(0, 0.5, (4, 12)).astype(np.float32)
    x, y = inputs.labelled_rows(rng, centers, 120)
    gnb, sgd = GNBMember("g").fit(x, y), SGDMember("s", seed=2).fit(x, y)
    xgb = NativeGBDTMember("x").fit(x, y)
    want = [host.gnb_fit(x, y), host.sgd_fit(x, y, 2)]
    assert check.state_gap(check.host_state(gnb), want[0]) == 0.0
    assert check.state_gap(check.host_state(sgd), want[1]) == 0.0
    edges = host.quantile_edges(x)
    start = check.host_state(xgb)
    assert check._edges_gap(start["edges"], edges) == 0.0
    assert host.boost_gap(host.binned(x, edges), y, start, 0, 4,
                          host.GBDT["lr"], split_trees={0, 1, 2, 3}) < 1e-9
    for _ in range(2):
        xu, yu = inputs.labelled_rows(rng, centers, 24)
        for m in (gnb, sgd, xgb):
            m.update(xu, yu)
        want = [host.gnb_update(want[0], xu, yu),
                host.sgd_update(want[1], xu, yu)]
        assert check.state_gap(check.host_state(gnb), want[0]) == 0.0
        assert check.state_gap(check.host_state(sgd), want[1]) == 0.0
        post = check.host_state(xgb)
        n = start["feature"].shape[0]
        assert host.boost_gap(host.binned(xu, edges), yu, post, n, 4,
                              host.GBDT["lr"],
                              split_trees=set(range(n, n + 400))) < 1e-9
        # the update's faults, put in the system's place, read far off
        assert host.boost_gap(host.binned(xu, edges), yu, post, n, 4,
                              host.GBDT["lr"], lam_fault=True) > 1e-2
        bad = host.sgd_update(want[1], xu, yu, fault=True)
        assert check.state_gap(bad, host.sgd_update(want[1], xu, yu)) > 1e-2
        start = post


def test_entropy_selection_and_f1_are_the_ports():
    from consensus_entropy_tpu_torch.al.reporting import weighted_f1
    from consensus_entropy_tpu_torch.ops.entropy import shannon_entropy
    from consensus_entropy_tpu_torch.ops.scoring import consensus_mean

    rng = np.random.default_rng(2)
    p = rng.dirichlet(np.ones(4), (20, 50)).astype(np.float32)
    want = shannon_entropy(consensus_mean(torch.from_numpy(p))).numpy()
    h = select.consensus_entropy(p)
    np.testing.assert_allclose(h, want, rtol=1e-5, atol=1e-6)
    top = select.top_q(h, 10)
    assert select.selection_gap(h, top) == 0.0
    worse = list(top[:-1]) + [int(np.argmin(h))]
    assert select.selection_gap(h, worse) == pytest.approx(
        np.sort(h)[::-1][9] - h.min())
    assert select.selection_gap(h, [1, 1]) == select.WRONG
    yt, yp = rng.integers(0, 4, 60), rng.integers(0, 4, 60)
    assert select.weighted_f1(yt, yp) == pytest.approx(weighted_f1(yt, yp),
                                                       abs=1e-15)


def test_near_ties_go_either_way():
    probs = np.array([[0.5, 0.49995, 0.1, 0.1],
                      [0.1, 0.7, 0.2, 0.0],
                      [0.3, 0.1, 0.6, 0.0]])
    y = [1, 1, 2]
    got = check._f1_choices(y, probs)
    assert len(got) == 2
    assert select.weighted_f1(y, [0, 1, 2]) in got
    assert select.weighted_f1(y, [1, 1, 2]) in got
