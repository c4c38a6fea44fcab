"""The port's CNN trainer against the JAX package's, on the CPU.

BCE and the in-graph weighted F1 match JAX (and scikit-learn); each
schedule phase's torch optimizer takes the steps optax takes (coupled
weight decay, Adam's bias corrections, Nesterov momentum) within rtol 1e-5
/ atol 1e-7 over ten steps; the epoch-indexed schedule's transitions are
the JAX trainer's.  A 3-epoch ``fit_many`` of two TINY members draws what
the JAX epoch draws (permutations, crop starts, test crop starts and the
dropout keys, recomputed here with ``jax.random`` along the JAX key chain,
equal bit for bit), gates the same epochs, and ends within rtol 1e-3 /
atol 1e-4 of the JAX losses and rtol 1e-3 / atol 2e-3 of its weights
(float32 convolutions summed in two orders, through 12 optimizer steps).
A retrain with no improved epoch keeps the incoming member untouched."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from sklearn.metrics import f1_score

from consensus_entropy_tpu.config import CNNConfig as JaxCNNConfig
from consensus_entropy_tpu.config import TrainConfig as JaxTrainConfig
from consensus_entropy_tpu.data.audio import DeviceWaveformStore as JaxStore
from consensus_entropy_tpu.models import cnn_trainer as jax_trainer
from consensus_entropy_tpu.models import short_cnn as jax_cnn
from consensus_entropy_tpu_torch import convert, prng
from consensus_entropy_tpu_torch.config import CNNConfig, TrainConfig
from consensus_entropy_tpu_torch.data.audio import DeviceWaveformStore
from consensus_entropy_tpu_torch.labels import one_hot_np
from consensus_entropy_tpu_torch.models import cnn_trainer
from consensus_entropy_tpu_torch.models.committee import CNNMember, Committee

torch.set_num_threads(1)

TINY_KW = dict(n_channels=4, n_mels=32, n_layers=5, input_length=8192)
TINY, JAX_TINY = CNNConfig(**TINY_KW), JaxCNNConfig(**TINY_KW)
TC_KW = dict(batch_size=4, adam_patience=2, sgd_patience=1)
_init = jax.jit(lambda k: jax_cnn.init_variables(k, JAX_TINY))


def test_bce_matches_jax_and_clamps():
    rng = np.random.default_rng(0)
    p = rng.uniform(0, 1, (6, 4)).astype(np.float32)
    p[0, 0], p[1, 1] = 0.0, 1.0  # logs clamped at -100
    y = one_hot_np(rng.integers(0, 4, 6))
    np.testing.assert_allclose(
        cnn_trainer.bce_per_sample(torch.from_numpy(p),
                                   torch.from_numpy(y)).numpy(),
        np.asarray(jax_trainer.bce_per_sample(p, y)), rtol=1e-6)
    np.testing.assert_allclose(
        float(cnn_trainer.bce_loss(torch.from_numpy(p), torch.from_numpy(y))),
        float(jax_trainer.bce_loss(p, y)), rtol=1e-6)
    assert float(cnn_trainer.bce_per_sample(
        torch.tensor([[1.0, 0, 0, 0]]), torch.tensor([[0.0, 1, 0, 0]]))) == \
        pytest.approx(50.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_f1_matches_jax_and_sklearn(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 4 - seed, 20)  # seed 1, 2: absent classes
    preds = rng.uniform(0, 1, (20, 4)).astype(np.float32)
    got = float(cnn_trainer.weighted_f1_in_graph(
        torch.from_numpy(preds), torch.from_numpy(one_hot_np(y))))
    assert got == pytest.approx(float(jax_trainer.weighted_f1_in_graph(
        preds, one_hot_np(y))), rel=1e-6)
    assert got == pytest.approx(f1_score(y, preds.argmax(1),
                                         average="weighted",
                                         zero_division=0), rel=1e-6)


@pytest.mark.parametrize("phase", cnn_trainer.PHASES)
def test_optimizer_steps_match_optax(phase):
    rng = np.random.default_rng(3)
    shapes = {"w": (5, 3), "b": (3,), "s": (2, 2, 3)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(10)]
    tx = jax_trainer.make_tx(phase, JaxTrainConfig())
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    ours = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    opt = cnn_trainer.make_optimizer(phase, list(ours.values()),
                                     TrainConfig())
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)
        for k, t in ours.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
    for k, t in ours.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("n_epochs, adam_patience, sgd_patience", [
    (9, 2, 2), (100, 20, 20), (3, 1, 1), (0, 20, 20), (50, 40, 5)])
def test_schedule_matches_jax(n_epochs, adam_patience, sgd_patience):
    trainer = jax_trainer.CNNTrainer(
        JAX_TINY, JaxTrainConfig(sgd_patience=sgd_patience))
    assert cnn_trainer.phase_segments(
        n_epochs, adam_patience, sgd_patience) == trainer._phase_segments(
            n_epochs, adam_patience)
    order = []
    cnn_trainer.run_schedule(n_epochs, adam_patience, sgd_patience,
                             lambda e, p: order.append(("epoch", e, p)),
                             lambda p: order.append(("reload", p)))
    ref = []
    trainer._run_schedule(n_epochs, adam_patience,
                          lambda e, p: ref.append(("epoch", e, p)),
                          lambda p: ref.append(("reload", p)))
    assert order == ref


@pytest.fixture(scope="module")
def pool():
    rng = np.random.default_rng(11)
    ids = [f"s{i}" for i in range(9)]
    waves = {s: rng.standard_normal(int(rng.integers(8200, 12000))).astype(
        np.float32) for s in ids}
    y = one_hot_np(rng.integers(0, 4, 9))
    return waves, ids, y


def _jax_draws(key, i, n_train, n_test, lengths, tr, te, epochs, bs):
    """The JAX epoch's draws for member ``i`` along ``fit_many``'s key
    chain (``cnn_trainer.py:188-199``)."""
    k = jax.random.fold_in(key, i)
    n_batches = -(-n_train // bs)
    used, out = n_batches * bs, []
    for _ in range(epochs):
        k, sub = jax.random.split(k)
        kperm, kcrop, ktest, kdrop = jax.random.split(sub, 4)
        perm = np.asarray(jax.random.permutation(kperm, n_train))
        perm = np.concatenate([perm, perm[:used - n_train]])
        u = np.asarray(jax.random.uniform(kcrop, (used,)))
        starts = np.floor(u * (lengths[tr][perm] - 8192).astype(
            np.float32)).astype(np.int64)
        ut = np.asarray(jax.random.uniform(ktest, (n_test,)))
        tstarts = np.floor(ut * (lengths[te] - 8192).astype(
            np.float32)).astype(np.int64)
        dkeys = np.asarray(jax.random.key_data(jax.random.split(
            kdrop, n_batches)))
        out.append((perm, starts, tstarts, dkeys))
    return out


def test_fit_many_matches_jax(pool):
    waves, ids, y = pool
    tr, te = ids[:6], ids[6:]
    jv = [_init(jax.random.key(i)) for i in range(2)]
    jbest, jhist = jax_trainer.CNNTrainer(
        JAX_TINY, JaxTrainConfig(**TC_KW)).fit_many(
            jv, JaxStore(waves, 8192), tr, y[:6], te, y[6:],
            jax.random.key(5), n_epochs=3)
    trainer = cnn_trainer.CNNTrainer(TINY, TrainConfig(**TC_KW))
    trainer.draws = []
    store = DeviceWaveformStore(waves, 8192, "cpu")
    best, hist = trainer.fit_many(
        [convert.cnn_variables_from_jax(v, TINY, "cpu") for v in jv], store,
        tr, y[:6], te, y[6:], prng.key(5, "cpu"), n_epochs=3)
    lengths = store.lengths.numpy()
    for i in range(2):
        ref = _jax_draws(jax.random.key(5), i, 6, 3, lengths,
                         store.row_of(tr), store.row_of(te), 3, 4)
        for got, (perm, starts, tstarts, dkeys) in zip(
                trainer.draws[3 * i: 3 * i + 3], ref):
            np.testing.assert_array_equal(got["perm"].numpy(), perm)
            np.testing.assert_array_equal(got["starts"].numpy(), starts)
            np.testing.assert_array_equal(got["test_starts"].numpy(),
                                          tstarts)
            np.testing.assert_array_equal(
                got["dropout_keys"].view(torch.int32).numpy().view(
                    np.uint32), dkeys)
    for h, r in zip(hist, jhist):
        assert [e["phase"] for e in h] == ["adam", "adam", "sgd_1"]
        assert [e["improved"] for e in h] == [e["improved"] for e in r]
        for e, er in zip(h, r):
            for k in ("train_loss", "val_loss", "val_f1"):
                np.testing.assert_allclose(e[k], er[k], rtol=1e-3,
                                           atol=1e-4, err_msg=k)
    for b, jb in zip(best, jbest):
        ref = convert.cnn_variables_from_jax(jb, TINY, "cpu")
        for k, t in b.items():
            np.testing.assert_allclose(t.numpy(), ref[k].numpy(), rtol=1e-3,
                                       atol=2e-3, err_msg=k)


def test_retrain_without_improvement_keeps_the_member(pool, monkeypatch):
    waves, ids, y = pool
    store = DeviceWaveformStore(waves, 8192, "cpu")
    variables = convert.cnn_variables_from_jax(_init(jax.random.key(0)),
                                               TINY, "cpu")
    member = CNNMember("c0", variables, TINY)
    member.ckpt_dirty = False
    com = Committee([], [member], TINY, TrainConfig(**TC_KW), device="cpu")
    # every validation loss >= 1: score = 1 - loss never beats 0
    monkeypatch.setattr(cnn_trainer, "bce_loss",
                        lambda p, t: torch.tensor(1.5))
    hist = com.retrain_cnns(store, ids[:4], y[:4], ids[4:], y[4:],
                            prng.key(1, "cpu"), n_epochs=2)
    assert not any(e["improved"] for e in hist[0])
    assert member.variables is variables and not member.ckpt_dirty
    # a loss under 1 improves on the gate: the member takes the new best
    monkeypatch.setattr(cnn_trainer, "bce_loss",
                        lambda p, t: torch.tensor(0.5))
    hist = com.retrain_cnns(store, ids[:4], y[:4], ids[4:], y[4:],
                            prng.key(1, "cpu"), n_epochs=2)
    assert [e["improved"] for e in hist[0]] == [True, False]
    assert member.variables is not variables and member.ckpt_dirty
