"""Every member fit of ``CNNTrainer.fit`` runs on a static slot; on the
card its epochs are captured once as CUDA graphs and replayed.

A member-epoch has fixed shapes: the split's sizes, the batch, the store,
the phase and the configuration.  Launched eagerly on the card it is some
2,400 small kernels (the threefry draws as int64 elementwise ops, the
training steps, the validation forward, the optimizer, the
best-checkpoint gate), and the launching thread, not the card, paces it.
So on a CUDA store the first epoch of a new signature
(:meth:`EpochGraphs.signature`) and phase is captured as one CUDA graph,
and every later epoch with that signature, of any fit, replays it: one
launch.

The epochs read and write one static :class:`Slot` a signature: the
member's parameters, BatchNorm statistics and each phase's optimizer
state, the best copy and its score, the running key, the split's rows and
one-hot targets, and ``(n_epochs, ...)`` buffers of each epoch's history
row and draws, written at a device-side epoch counter.  A fit copies its
member, split and key into the slot, runs its epochs, clones the best copy
out and reads the history (and, where the trainer records them, the
draws) once.  No tensor a fit returns aliases the slot, which the next
fit overwrites.  Off CUDA the same slot runs each epoch eagerly.

The epoch is ``CNNTrainer._epoch`` itself, draw for draw.  On the card
Adam keeps its step count on the device (``capturable=True``), so its
bias correction rounds otherwise than a plain Adam's and members differ
from one by float32 rounding.  A phase's optimizer is reset by zeroing
its state: a zero SGD momentum buffer gives the bits of its first-step
clone, a zero Adam step count those of a fresh Adam.

The first epoch of a signature and phase runs eagerly on the capture's
stream (the warm-up a capture needs; it is the fit's own epoch), then is
captured on the fitting thread with ``capture_error_mode="thread_local"``,
so the host workers and checkpoint threads keep running.  A capture that
raises fails the fit.

Every graph on a device allocates from one private memory pool, which
keeps the largest epoch's peak (its validation forward) for the life of
the process.  Graphs never run at once: fits on the slots take turns under
one lock, and each ends in a host read after its last replay.  A slot
whose store has been freed is dropped at the next fit.
"""

from __future__ import annotations

import contextlib
import threading
import weakref

import torch

from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.models import short_cnn

#: the draws each epoch records in its slot (``CNNTrainer.draws``' keys)
DRAWS = ("perm", "starts", "test_starts", "dropout_keys")


def _copy(dst: list, src: list) -> None:
    """``dst[i].copy_(src[i])``: one foreach launch where every source is
    on the destinations' device."""
    if all(s.device == d.device for s, d in zip(src, dst)):
        torch._foreach_copy_(dst, src)
    else:
        for d, s in zip(dst, src):
            d.copy_(s)


class Slot:
    """One signature's static tensors, its graphs by phase, and the fit
    running on it (from :meth:`load` to :meth:`best_copy`)."""

    def __init__(self, engine: "EpochGraphs", trainer, store,
                 variables: dict, n_train: int, n_test: int,
                 batch_size: int, n_epochs: int):
        dev = store.device
        self.engine, self.trainer = engine, trainer
        self.store = weakref.ref(store)
        self.batch_size = batch_size

        def like(t, **kw):
            return torch.empty(t.shape, dtype=t.dtype, device=dev, **kw)

        self.params = {k: like(t, requires_grad=True)
                       for k, t in variables.items()
                       if not short_cnn.is_stat(k)}
        self.stats = {k: like(t) for k, t in variables.items()
                      if short_cnn.is_stat(k)}
        self.best = {k: like(variables[k])
                     for k in (*self.params, *self.stats)}
        self.best_score = torch.zeros((), device=dev)
        self.key = torch.zeros(2, dtype=torch.int32, device=dev)
        n_class = trainer.config.n_class
        self.train_rows = torch.zeros(n_train, dtype=torch.int64, device=dev)
        self.test_rows = torch.zeros(n_test, dtype=torch.int64, device=dev)
        self.train_y = torch.zeros((n_train, n_class), device=dev)
        self.test_y = torch.zeros((n_test, n_class), device=dev)
        self.hist = torch.zeros((n_epochs, 4), device=dev)
        self.ctr = torch.zeros(1, dtype=torch.int64, device=dev)
        n_batches = -(-n_train // batch_size)
        used = n_batches * batch_size
        self.draws = {
            "perm": torch.zeros((n_epochs, used), dtype=torch.int64,
                                device=dev),
            "starts": torch.zeros((n_epochs, used), dtype=torch.int64,
                                  device=dev),
            "test_starts": torch.zeros((n_epochs, n_test),
                                       dtype=torch.int64, device=dev),
            "dropout_keys": torch.zeros((n_epochs, n_batches, 2),
                                        dtype=torch.int32, device=dev)}
        self.opts: dict = {}
        self.graphs: dict = {}
        #: of the fit running on the slot: epochs run, whether one
        #: replayed a graph, whether it captured one
        self.epochs = 0
        self.graphed = self.captured = False

    # -- a fit ------------------------------------------------------------

    def load(self, variables: dict, train_rows, train_y, test_rows, test_y,
             key, first_phase: str) -> None:
        """Start a fit: the member's variables (best copy too), the split,
        the key; a zero score and epoch counter; a fresh optimizer."""
        with torch.no_grad():
            dst = [*self.params.values(), *self.stats.values(),
                   *self.best.values()]
            _copy(dst, [variables[k] for k in
                        (*self.params, *self.stats, *self.best)])
            _copy([self.train_rows, self.train_y, self.test_rows,
                   self.test_y, self.key],
                  [train_rows, train_y, test_rows, test_y,
                   key.view(torch.int32)])
            # the reference's best metric starts at 0 (amg_test.py:295)
            self.best_score.zero_()
            self.ctr.zero_()
        self._reset_opt(first_phase)
        self.epochs = 0
        self.graphed = self.captured = False

    def epoch(self, phase: str) -> None:
        """One epoch: a replay of the phase's graph, else an eager run and,
        where the engine captures on the slot's device, on the capture's
        stream, then the phase's capture."""
        self.epochs += 1
        g = self.graphs.get(phase)
        if g is not None:
            g.replay()
            self.graphed = True
            return
        dev = self.store().device
        if not self.engine.captures_on(dev):
            self._body(phase)
            return
        side = self.engine.stream(dev)
        with _on_stream(side):
            self._body(phase)
        self.graphs[phase] = self._capture(phase, side)
        self.engine.captures += 1
        self.captured = True

    def reload_best(self, phase: str) -> None:
        """A phase transition: the best copy back into the member, and the
        new phase's optimizer fresh."""
        with torch.no_grad():
            _copy([*self.params.values(), *self.stats.values()],
                  [self.best[k] for k in (*self.params, *self.stats)])
        self._reset_opt(phase)

    def best_copy(self) -> dict:
        """A clone of the best copy, in fresh memory."""
        out = {k: torch.empty_like(t) for k, t in self.best.items()}
        with torch.no_grad():
            _copy(list(out.values()), list(self.best.values()))
        return out

    def history(self) -> torch.Tensor:
        """``(epochs, 4)`` on the device: train loss, validation loss and
        F1, improved."""
        return self.hist[:self.epochs]

    def recorded_draws(self) -> list:
        """Each epoch's draws, ``CNNTrainer.draws``' entries: one host
        copy a buffer (a copy on the CPU too: the next fit overwrites the
        slot)."""
        host = {k: t[:self.epochs].to("cpu", copy=True)
                for k, t in self.draws.items()}
        host["dropout_keys"] = host["dropout_keys"].view(torch.uint32)
        return [{k: t[e] for k, t in host.items()}
                for e in range(self.epochs)]

    # -- inside ---------------------------------------------------------

    def _opt(self, phase: str):
        if phase not in self.opts:
            from consensus_entropy_tpu_torch.models.cnn_trainer import (
                make_optimizer,
            )

            self.opts[phase] = make_optimizer(
                phase, list(self.params.values()),
                self.trainer.train_config,
                capturable=self.store().device.type == "cuda")
        return self.opts[phase]

    def _reset_opt(self, phase: str) -> None:
        """Zero the phase optimizer's state: a fresh optimizer's."""
        opt = self._opt(phase)
        state = [v for p in self.params.values()
                 for v in opt.state.get(p, {}).values()
                 if isinstance(v, torch.Tensor)]
        if state:
            torch._foreach_zero_(state)

    def _body(self, phase: str) -> None:
        """The epoch on the slot's tensors (``CNNTrainer._epoch``), its
        results written in place: what a capture records."""
        keys = prng.split(self.key.view(torch.uint32))
        st = {"params": self.params, "stats": self.stats,
              "opt": self._opt(phase), "best": self.best,
              "best_score": self.best_score}
        tl, vl, f1, imp = self.trainer._epoch(
            st, self.store(), self.train_rows, self.train_y, self.test_rows,
            self.test_y, keys[1], phase, self.batch_size)
        with torch.no_grad():
            self.key.copy_(keys[0].view(torch.int32))
            _copy([*self.stats.values(), *self.best.values()],
                  [st["stats"][k] for k in self.stats]
                  + [st["best"][k] for k in self.best])
            self.best_score.copy_(st["best_score"])
            self.hist.index_copy_(0, self.ctr, torch.stack(
                [tl, vl, f1, imp.to(tl.dtype)])[None])
            for name in DRAWS:
                t = st["draws"][name]  # uint32 keys go as their int32 words
                self.draws[name].index_copy_(0, self.ctr, (
                    t.view(torch.int32) if t.dtype == torch.uint32
                    else t)[None])
            self.ctr.add_(1)

    def _capture(self, phase: str, side):
        g = torch.cuda.CUDAGraph()
        pool = self.engine.pool(self.store().device)
        with torch.cuda.stream(side), torch.cuda.graph(
                g, pool=pool, stream=side,
                capture_error_mode="thread_local"):
            self._body(phase)
        return g


@contextlib.contextmanager
def _on_stream(side):
    """Run the block on ``side``, ordered after the current stream's work
    and before its next."""
    cur = torch.cuda.current_stream(side.device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        yield
    cur.wait_stream(side)


class EpochGraphs:
    """The process's member-epochs: one :class:`Slot` a signature, each
    holding a captured graph a phase.  ``captures`` counts the captures
    made."""

    def __init__(self):
        self.slots: dict = {}
        self.captures = 0
        self._streams: dict = {}
        self._pools: dict = {}
        self._lock = threading.Lock()

    @staticmethod
    def captures_on(device) -> bool:
        """Whether epochs on ``device`` are captured: a CUDA device."""
        return device.type == "cuda"

    @staticmethod
    def signature(store, trainer, variables: dict, n_train: int,
                  n_test: int, batch_size: int, n_epochs: int) -> tuple:
        """What a captured epoch is specialised to: the device, the store
        (its identity and buffers), the split's sizes, the batch, the
        configurations, the epoch count and the variables' names, dtypes
        and shapes.  A graph is this and a phase."""
        return (str(store.device), id(store), store.data.data_ptr(),
                store.lengths.data_ptr(), n_train, n_test, batch_size,
                trainer.config, trainer.train_config, n_epochs,
                tuple((k, t.dtype, tuple(t.shape))
                      for k, t in variables.items()))

    def stream(self, device):
        """The capture's stream on ``device``."""
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def pool(self, device):
        """The private memory pool every graph on ``device`` shares."""
        if device not in self._pools:
            with torch.cuda.device(device):
                self._pools[device] = torch.cuda.graph_pool_handle()
        return self._pools[device]

    @contextlib.contextmanager
    def fit(self, trainer, store, variables: dict, train_rows, train_y,
            test_rows, test_y, key, batch_size: int, n_epochs: int,
            first_phase: str):
        """The slot of this fit's signature, loaded with its member, split
        and key, held for the fit (fits take turns)."""
        dev = store.device
        with self._lock, (torch.cuda.device(dev) if dev.type == "cuda"
                          else contextlib.nullcontext()):
            for s in [s for s, slot in self.slots.items()
                      if slot.store() is None]:
                del self.slots[s]
            sig = self.signature(store, trainer, variables, len(train_rows),
                                 len(test_rows), batch_size, n_epochs)
            slot = self.slots.get(sig)
            if slot is None:
                slot = self.slots[sig] = Slot(
                    self, trainer, store, variables, len(train_rows),
                    len(test_rows), batch_size, n_epochs)
            slot.load(variables, train_rows, train_y, test_rows, test_y, key,
                      first_phase)
            try:
                yield slot
            except BaseException:
                # no replay of this fit may still run when the next loads
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                raise


#: the graphs every ``CNNTrainer`` shares by default: one capture serves
#: the fits of every committee in the process
EPOCH_GRAPHS = EpochGraphs()
