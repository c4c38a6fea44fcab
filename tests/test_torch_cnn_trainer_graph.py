"""The CNN trainer's slots and captured member-epochs
(``models/epoch_graph.py``).

On the CPU: a fit runs its epochs on a slot, uncaptured, and its
``retrain.fit`` span says so; the draws it records come out of the slot;
a fit on a slot is ``CNNTrainer._epoch`` run epoch by epoch with a fresh
optimizer a phase, bit for bit, on a fresh slot or on one a fit of
another member used before, and hands back tensors of its own; the graph
signature tells devices, stores, shapes, configurations and variables
apart; a capture that raises fails the fit; and ``prng.bernoulli`` draws
what ``uniform < p`` drew before it stopped copying a scalar ``p`` to the
draw's device.

On the card (marked ``card``; each skips without CUDA), with cuDNN
deterministic: a committee's graphed retrain (5 members at ``paper-vgg``'s
shapes and reduced width, one capture) equals, bit for bit, the same
retrain launched op by op (its draws, histories and members).  Another
member of another user replays the graph without a new capture and
leaves the first fit's tensors as they were; a new ``n_train`` captures
anew; a capture that CUDA refuses fails the fit; dropout masks drawn on
the card are the CPU's.  Run them on the card with ``python -m pytest
tests/test_torch_cnn_trainer_graph.py -q -m card --noconftest`` (the
tests' conftest imports the JAX package, whose Flax the card's machine
lacks).
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.config import CNNConfig, TrainConfig
from consensus_entropy_tpu_torch.data.audio import DeviceWaveformStore
from consensus_entropy_tpu_torch.labels import one_hot_np
from consensus_entropy_tpu_torch.models import (
    cnn_trainer,
    epoch_graph,
    short_cnn,
)
from consensus_entropy_tpu_torch.models.cnn_trainer import CNNTrainer
from consensus_entropy_tpu_torch.models.epoch_graph import EpochGraphs
from consensus_entropy_tpu_torch.obs.trace import Tracer

torch.set_num_threads(1)

TINY = CNNConfig(n_channels=4, n_mels=32, n_layers=5, input_length=8192)
TC = TrainConfig(batch_size=4, adam_patience=2, sgd_patience=1)


@pytest.fixture(scope="module")
def pool():
    rng = np.random.default_rng(21)
    ids = [f"s{i}" for i in range(9)]
    waves = {s: rng.standard_normal(int(rng.integers(8200, 12000))).astype(
        np.float32) for s in ids}
    return (DeviceWaveformStore(waves, 8192, "cpu"), ids,
            one_hot_np(rng.integers(0, 4, 9)))


def _fit(trainer, store, ids, y, seed, n_epochs, tracer=None, member=0):
    variables = short_cnn.init_variables(prng.key(seed, "cpu"),
                                         trainer.config, store.device)
    kw = {} if tracer is None else {"tracer": tracer, "member": member}
    return trainer.fit(variables, store, ids[:6], y[:6], ids[6:], y[6:],
                       prng.key(seed + 100, "cpu"), n_epochs=n_epochs, **kw)


def _trainer(graphs=None, draws=None):
    t = CNNTrainer(TINY, TC)
    t.graphs = EpochGraphs() if graphs is None else graphs
    t.draws = draws
    return t


def _fits(tracer):
    return [r for r in tracer.records if r["name"] == "retrain.fit"]


def _plain_fit(store, ids, y, seed, n_epochs):
    """``CNNTrainer._epoch`` epoch by epoch on fresh tensors, a fresh
    optimizer a phase: what a fit on a slot computes."""
    trainer = CNNTrainer(TINY, TC)
    variables = short_cnn.init_variables(prng.key(seed, "cpu"), TINY, "cpu")
    params = {k: t.clone().requires_grad_(True) for k, t in variables.items()
              if not short_cnn.is_stat(k)}
    st = {"params": params,
          "stats": {k: t.clone() for k, t in variables.items()
                    if short_cnn.is_stat(k)},
          "best": {k: t.clone() for k, t in variables.items()},
          "best_score": torch.zeros(()), "key": prng.key(seed + 100, "cpu")}
    rows = [torch.as_tensor(store.row_of(s)) for s in (ids[:6], ids[6:])]
    ys = [torch.as_tensor(t, dtype=torch.float32) for t in (y[:6], y[6:])]
    history, draws = [], []

    def run_epoch(epoch, phase):
        if "opt" not in st:
            st["opt"] = cnn_trainer.make_optimizer(
                phase, list(params.values()), TC)
        st["key"], sub = prng.split(st["key"])
        tl, vl, f1, imp = trainer._epoch(st, store, rows[0], ys[0], rows[1],
                                         ys[1], sub, phase, TC.batch_size)
        history.append({"epoch": epoch, "phase": phase,
                        "train_loss": float(tl), "val_loss": float(vl),
                        "val_f1": float(f1), "improved": bool(imp)})
        draws.append(st["draws"])

    def reload_best(phase):
        with torch.no_grad():
            for k, t in params.items():
                t.copy_(st["best"][k])
        st["stats"] = {k: st["best"][k].clone() for k in st["stats"]}
        st["opt"] = cnn_trainer.make_optimizer(phase, list(params.values()),
                                               TC)

    cnn_trainer.run_schedule(n_epochs, TC.adam_patience, TC.sgd_patience,
                             run_epoch, reload_best)
    return st["best"], history, draws


@pytest.mark.parametrize("draws", [None, []])
def test_cpu_fits_and_recorded_draws_stay_eager(pool, draws):
    store, ids, y = pool
    trainer = _trainer(draws=draws)
    tracer = Tracer(None, run_id="eager")
    _, hist = _fit(trainer, store, ids, y, 1, 2, tracer)
    assert len(hist) == 2
    fit, = _fits(tracer)
    assert (fit["graphed"], fit["captured"]) == (False, False)
    slot, = trainer.graphs.slots.values()
    assert trainer.graphs.captures == 0 and slot.graphs == {}
    if draws is not None:
        assert len(draws) == 2 and set(draws[0]) == set(epoch_graph.DRAWS)
        assert draws[0]["dropout_keys"].dtype == torch.uint32
    assert EpochGraphs.captures_on(torch.device("cuda", 0))
    assert not EpochGraphs.captures_on(store.device)


def test_a_fit_on_a_slot_is_the_epochs_bit_for_bit(pool):
    store, ids, y = pool
    graphs = EpochGraphs()
    trainer = _trainer(graphs, draws=[])
    # 4 epochs: adam, adam, sgd_1, sgd_2 (patience 2, then 1); the second
    # and third fits load the slot the first left
    firsts, want_draws = [], []
    for seed in (1, 2, 1):
        got, got_h = _fit(trainer, store, ids, y, seed, 4)
        want, want_h, want_d = _plain_fit(store, ids, y, seed, 4)
        assert [e["phase"] for e in got_h] == ["adam", "adam", "sgd_1",
                                               "sgd_2"]
        assert got_h == want_h
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        want_draws += want_d
        firsts.append((got, {k: t.clone() for k, t in got.items()}))
    # each fit's draws, as later fits left them
    for g, w in zip(trainer.draws, want_draws, strict=True):
        for k in epoch_graph.DRAWS:
            assert torch.equal(g[k], w[k]), k
    slot, = graphs.slots.values()
    slot_ptrs = {t.data_ptr() for t in (*slot.params.values(),
                                        *slot.stats.values(),
                                        *slot.best.values())}
    for got, kept in firsts:  # later fits left each fit's tensors alone
        assert not slot_ptrs & {t.data_ptr() for t in got.values()}
        for k, t in kept.items():
            assert torch.equal(got[k], t), k


def test_signature_separates_devices_stores_shapes_and_configs(pool):
    store, ids, _ = pool
    trainer = _trainer()
    variables = short_cnn.init_variables(prng.key(0, "cpu"), TINY, "cpu")

    def sig(st=store, tr=trainer, v=variables, n_train=6, n_test=3,
            batch=4, n_epochs=10):
        return EpochGraphs.signature(st, tr, v, n_train, n_test, batch,
                                     n_epochs)

    on = types.SimpleNamespace(device=torch.device("cuda", 1),
                               data=store.data, lengths=store.lengths)
    other = DeviceWaveformStore.from_padded(
        store.ids, store.data.clone(), store.lengths.clone(), 8192)
    half = {k: (t.to(torch.bfloat16) if k == "dense2.weight" else t)
            for k, t in variables.items()}
    sigs = [sig(), sig(st=on), sig(st=other), sig(n_train=5), sig(n_test=4),
            sig(batch=3), sig(n_epochs=9), sig(v=half),
            sig(tr=CNNTrainer(TINY, TrainConfig(batch_size=4, lr=1e-3))),
            sig(tr=CNNTrainer(CNNConfig(n_channels=4, n_mels=32, n_layers=5,
                                        input_length=8192,
                                        dropout_rate=0.25), TC))]
    assert len(set(sigs)) == len(sigs)
    assert sig() == sig(tr=_trainer())  # any trainer of the same configs


def test_a_capture_that_raises_fails_the_fit(pool, monkeypatch):
    store, ids, y = pool

    def refused(self, phase, side):
        raise RuntimeError("capture refused")

    graphs = EpochGraphs()
    trainer = _trainer(graphs)
    with monkeypatch.context() as mp:
        # a CPU store through the capture's path, the capture refused
        mp.setattr(graphs, "captures_on", lambda device: True)
        mp.setattr(graphs, "stream", lambda device: None)
        mp.setattr(epoch_graph, "_on_stream",
                   lambda side: contextlib.nullcontext())
        mp.setattr(epoch_graph.Slot, "_capture", refused)
        with pytest.raises(RuntimeError, match="capture refused"):
            _fit(trainer, store, ids, y, 1, 2)
    assert graphs.captures == 0
    _, hist = _fit(trainer, store, ids, y, 1, 2)  # the lock was let go
    assert len(hist) == 2


@pytest.mark.parametrize("p", [0.5, 0.3, 0.9, 1 / 3, 0.0, 1.0,
                               np.float32(0.7), torch.tensor(0.25)])
def test_bernoulli_of_a_scalar_is_uniform_below_p(p):
    key = prng.key(77, "cpu")
    want = prng.uniform(key, (6, 5)) < torch.as_tensor(p,
                                                       dtype=torch.float32)
    assert torch.equal(prng.bernoulli(key, p, (6, 5)), want)
    assert torch.equal(prng.bernoulli(key, p, (6, 5), device="cpu"), want)


def test_bernoulli_of_a_tensor_is_uniform_below_it():
    key = prng.key(78, "cpu")
    p = np.linspace(0.0, 1.0, 12, dtype=np.float64).reshape(3, 4)
    want = prng.uniform(key, (3, 4)) < torch.as_tensor(p,
                                                       dtype=torch.float32)
    assert torch.equal(prng.bernoulli(key, p), want)
    assert torch.equal(prng.bernoulli(key, torch.from_numpy(p)), want)
    assert prng.bernoulli(key, p).shape == (3, 4)


# -- on the card ----------------------------------------------------------

#: paper-vgg's geometry (7 layers, 128 mels, 59,049 samples) at reduced
#: width; its batch of 5, 10 epochs in Adam, a committee of 5 CNN members
CARD_CFG = CNNConfig(n_channels=16)
CARD_TC = TrainConfig(batch_size=5)
N_EPOCHS, N_MEMBERS = 10, 5


@pytest.fixture(scope="module")
def card():
    """One committee's retrain (5 members on 10 songs, validated on 60),
    cuDNN deterministic, draws recorded: graphed, and launched op by op on
    slots that never capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    n = 90
    waves = {f"c{i}": (0.1 * rng.standard_normal(
        CARD_CFG.input_length + int(rng.integers(0, 16000)))).astype(
            np.float32) for i in range(n)}
    store = DeviceWaveformStore(waves, CARD_CFG.input_length, "cuda")
    ids = list(waves)
    y = one_hot_np(rng.integers(0, 4, n))
    graphed, eager = CNNTrainer(CARD_CFG, CARD_TC), CNNTrainer(CARD_CFG,
                                                               CARD_TC)
    graphed.graphs, eager.graphs = EpochGraphs(), EpochGraphs()
    eager.graphs.captures_on = lambda device: False
    graphed.draws, eager.draws = [], []
    starts = [short_cnn.init_variables(prng.key(3 + i, "cpu"), CARD_CFG,
                                       "cuda") for i in range(N_MEMBERS)]
    split = (ids[:10], y[:10], ids[10:70], y[10:70], prng.key(4, "cpu"))
    tracer = Tracer(None, run_id="card")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.backends.cudnn, "deterministic", True)
        best, hists = graphed.fit_many(starts, store, *split,
                                       n_epochs=N_EPOCHS, tracer=tracer)
        ref, ref_hists = eager.fit_many(starts, store, *split,
                                        n_epochs=N_EPOCHS)
    slot, = graphed.graphs.slots.values()
    return types.SimpleNamespace(
        store=store, ids=ids, y=y, graphs=graphed.graphs, starts=starts,
        best=best, hists=hists, draws=graphed.draws, ref=ref,
        ref_hists=ref_hists, ref_draws=eager.draws, tracer=tracer,
        slot=slot, eager_graphs=eager.graphs)


@pytest.mark.card
def test_replays_are_the_epochs_launched_op_by_op(card):
    # the same kernels on the same inputs: bit for bit
    assert card.eager_graphs.captures == 0
    assert card.hists == card.ref_hists
    assert any(h["improved"] for hist in card.hists for h in hist[1:])
    for got, want in zip(card.best, card.ref):
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert len(card.draws) == len(card.ref_draws) == N_MEMBERS * N_EPOCHS
    for e, (got, want) in enumerate(zip(card.draws, card.ref_draws)):
        for k in epoch_graph.DRAWS:
            assert torch.equal(got[k], want[k]), (e, k)


@pytest.mark.card
def test_a_committee_captures_once_and_replays(card):
    assert card.graphs.captures == 1
    fits = _fits(card.tracer)
    assert [(f["graphed"], f["captured"]) for f in fits] == \
        [(True, True)] + [(True, False)] * (N_MEMBERS - 1)


@pytest.mark.card
def test_another_fit_replays_and_leaves_the_first_fit_alone(card):
    first = card.best[0]
    kept = {k: t.clone() for k, t in first.items()}
    slot_ptrs = {t.data_ptr() for t in (*card.slot.params.values(),
                                        *card.slot.stats.values(),
                                        *card.slot.best.values())}
    assert not slot_ptrs & {t.data_ptr() for b in card.best
                            for t in b.values()}
    other = CNNTrainer(CARD_CFG, CARD_TC)  # another user's committee
    other.graphs = card.graphs
    start = short_cnn.init_variables(prng.key(18, "cpu"), CARD_CFG, "cuda")
    tracer = Tracer(None, run_id="card2")
    best, hist = other.fit(start, card.store, card.ids[20:30],
                           card.y[20:30], card.ids[30:90], card.y[30:90],
                           prng.key(9, "cpu"), n_epochs=N_EPOCHS,
                           tracer=tracer, member=3)
    assert card.graphs.captures == 1 and len(hist) == N_EPOCHS
    fit, = _fits(tracer)
    assert (fit["graphed"], fit["captured"]) == (True, False)
    for k, t in first.items():
        assert torch.equal(t, kept[k]), k
    assert not all(torch.equal(best[k], kept[k]) for k in kept)


@pytest.mark.card
def test_a_new_n_train_captures_anew(card):
    before = card.graphs.captures
    trainer = CNNTrainer(CARD_CFG, CARD_TC)
    trainer.graphs = card.graphs
    _, hist = trainer.fit(card.starts[0], card.store, card.ids[:15],
                          card.y[:15], card.ids[15:75], card.y[15:75],
                          prng.key(10, "cpu"), n_epochs=3)
    assert card.graphs.captures == before + 1 and len(hist) == 3
    assert len(card.graphs.slots) == 2


@pytest.mark.card
@pytest.mark.parametrize("p", [0.5, 0.3, 1 / 3])
def test_bernoulli_on_the_card_draws_the_cpus_masks(p):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in range(4):
        key = prng.key(seed, "cpu")
        want = prng.bernoulli(key, p, (7, 33), device="cpu")
        assert torch.equal(prng.bernoulli(key, p, (7, 33),
                                          device="cuda").cpu(), want)
        assert torch.equal(prng.bernoulli(key.cuda(), p, (7, 33)).cpu(),
                           want)


@pytest.mark.card
def test_a_capture_cuda_refuses_fails_the_fit(card):
    # last: the refused capture leaves its own engine's pool recording
    graphs = EpochGraphs()
    trainer = CNNTrainer(CARD_CFG, CARD_TC)
    trainer.graphs = graphs
    real = epoch_graph.Slot._body

    def syncing(self, phase):
        real(self, phase)
        torch.cuda.synchronize()  # refused while the stream captures

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(epoch_graph.Slot, "_body", syncing)
        with pytest.raises(RuntimeError):
            trainer.fit(card.starts[1], card.store, card.ids[:10],
                        card.y[:10], card.ids[20:80], card.y[20:80],
                        prng.key(11, "cpu"), n_epochs=3)
    assert graphs.captures == 0
