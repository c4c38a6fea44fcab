"""CNN training with the reference's optimizer schedule, single device.

Counterpart of ``consensus_entropy_tpu/models/cnn_trainer.py`` (``:40-107``
losses, F1 and ``make_tx``; ``:179-262`` the epoch; ``:485-879`` the
schedule, ``fit`` and ``fit_many``), reproducing ``amg_test.py:203-341``:

- BCE on sigmoid outputs against one-hot targets, logs clamped at -100
  (``torch.nn.BCELoss``), weighted mean over the batch's samples;
- Adam (lr 1e-4, coupled weight decay 1e-4: ``torch.optim.Adam``'s
  ``weight_decay`` is optax's ``add_decayed_weights`` then ``adam``), then
  after ``adam_patience`` epochs Nesterov SGD (momentum 0.9, weight decay
  1e-4) at 1e-3, 1e-4, 1e-5, each ``sgd_patience`` epochs, reloading the
  best checkpoint and a fresh optimizer at every transition;
- each epoch: a permutation of the train songs with a zero-weight tail
  that fills the last batch, fresh random crops, the steps, then
  validation on fresh crops of the test songs; the best variables are
  kept by ``score = 1 - val_loss``, which starts at 0.

The random stream is the JAX epoch's, draw for draw: per epoch ``key, sub
= split(key)``, ``kperm, kcrop, ktest, kdrop = split(sub, 4)``, one dropout
key a batch from ``split(kdrop, n_batches)``, folded into the dropout
layer as Flax does (``prng.fold_in_static``).  So permutations, crops and
dropout masks equal the JAX package's; the losses and weights agree within
float32 rounding.

``fit_many`` trains member ``i`` under ``fold_in(key, i)``, one member
after another: the schedule depends on the epoch only, so the loop is the
JAX lockstep's math; with a training ``mesh`` (``:278-346, 695-760``) the
members are spread over its member axis, each trained on its device.
``fit_many_users`` (``:880-995``) does the same for a cohort of users, one
user after another (the JAX user lockstep is the same math), each under
its own key.

A fit runs its epochs on the static slot of its shape signature
(``models/epoch_graph.py``); on a CUDA store they replay a CUDA graph of
``_epoch`` captured once per signature and phase: one launch an epoch in
place of some 2,400.

With an enabled ``tracer`` (``obs.trace.Tracer``; the null one by
default) each member's fit writes a ``retrain.fit`` span under ``parent``
(``user``, ``member``, with the thread's CPU time; ``graphed``: an epoch
replayed a captured graph, ``captured``: the fit made a capture), and
under it a ``retrain.read`` span around the history's one host read,
which waits for the member's device work.
"""

from __future__ import annotations

import torch

from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.config import CNNConfig, TrainConfig
from consensus_entropy_tpu_torch.data.audio import crop_starts
from consensus_entropy_tpu_torch.models import short_cnn
from consensus_entropy_tpu_torch.models.epoch_graph import EPOCH_GRAPHS
from consensus_entropy_tpu_torch.obs.trace import NULL_TRACER

PHASES = ("adam", "sgd_1", "sgd_2", "sgd_3")  # amg_test.py:203-231


def bce_per_sample(preds, targets):
    """Per-sample BCE (mean over the class axis), torch's clamp."""
    p = torch.clamp(preds, 0.0, 1.0)
    log_p = torch.clamp(torch.log(torch.clamp(p, min=1e-44)), min=-100.0)
    log_1p = torch.clamp(torch.log(torch.clamp(1.0 - p, min=1e-44)),
                         min=-100.0)
    return -torch.mean(targets * log_p + (1.0 - targets) * log_1p, dim=-1)


def bce_loss(preds, targets):
    """``torch.nn.BCELoss``: the mean over all elements."""
    return torch.mean(bce_per_sample(preds, targets))


def weighted_f1_in_graph(preds, targets_onehot):
    """``f1_score(average='weighted', zero_division=0)`` of the argmax
    predictions, over the fixed class axis, on the device."""
    c = targets_onehot.shape[-1]
    # a comparison, not F.one_hot, whose range check waits for the device
    pred_oh = (preds.argmax(dim=-1)[:, None] == torch.arange(
        c, device=preds.device)).to(targets_onehot.dtype)
    tp = (targets_onehot * pred_oh).sum(dim=0)
    pred_n = pred_oh.sum(dim=0)
    true_n = targets_onehot.sum(dim=0)
    precision = torch.where(pred_n > 0, tp / torch.clamp(pred_n, min=1.0),
                            0.0)
    recall = torch.where(true_n > 0, tp / torch.clamp(true_n, min=1.0), 0.0)
    pr = precision + recall
    f1 = torch.where(pr > 0, 2.0 * precision * recall
                     / torch.clamp(pr, min=1e-30), 0.0)
    return (true_n * f1).sum() / torch.clamp(true_n.sum(), min=1.0)


def make_optimizer(phase: str, params: list, cfg: TrainConfig, *,
                   capturable: bool = False):
    """The phase's optimizer over ``params``, torch-coupled weight decay
    (optax ``add_decayed_weights`` before ``adam`` / ``sgd``).
    ``capturable``: Adam keeps its step count on the device, as a CUDA
    graph of the step needs (``models/epoch_graph.py``)."""
    if phase == "adam":
        return torch.optim.Adam(params, lr=cfg.lr,
                                weight_decay=cfg.weight_decay,
                                capturable=capturable)
    return torch.optim.SGD(params, lr=cfg.sgd_lrs[PHASES.index(phase) - 1],
                           momentum=cfg.sgd_momentum, nesterov=True,
                           weight_decay=cfg.sgd_weight_decay)


def run_schedule(n_epochs: int, adam_patience: int, sgd_patience: int,
                 run_epoch, reload_best) -> None:
    """The epoch-indexed adam -> sgd schedule (``amg_test.py:203-231``):
    ``run_epoch(epoch, phase)``; at each transition ``reload_best(phase)``.
    ``drop_counter`` resets only at transitions, never on improvement."""
    phase_i = drop_counter = 0
    for epoch in range(n_epochs):
        drop_counter += 1
        run_epoch(epoch, PHASES[phase_i])
        patience = adam_patience if PHASES[phase_i] == "adam" \
            else sgd_patience
        if phase_i < len(PHASES) - 1 and drop_counter >= patience:
            phase_i += 1
            reload_best(PHASES[phase_i])
            drop_counter = 0


def _store_on(store, device):
    """``store``, or its copy on ``device`` (made once and kept on the
    store)."""
    if device is None or store.device == device:
        return store
    copies = store.__dict__.setdefault("_device_copies", {})
    if device not in copies:
        copies[device] = type(store).from_padded(
            store.ids, store.data.to(device), store.lengths.to(device),
            store.input_length)
    return copies[device]


def phase_segments(n_epochs: int, adam_patience: int,
                   sgd_patience: int) -> list[tuple]:
    """``[(phase, start_epoch, end_epoch), ...]`` of :func:`run_schedule`,
    computed by replaying it."""
    eps: list[tuple] = []
    run_schedule(n_epochs, adam_patience, sgd_patience,
                 lambda e, p: eps.append((e, p)), lambda p: None)
    segs: list[tuple] = []
    for e, p in eps:
        if segs and segs[-1][0] == p:
            segs[-1] = (p, segs[-1][1], e + 1)
        else:
            segs.append((p, e, e + 1))
    return segs


class CNNTrainer:
    """Retrains CNN members on a waveform store's songs."""

    def __init__(self, config: CNNConfig = CNNConfig(),
                 train_config: TrainConfig = TrainConfig()):
        self.config = config
        self.train_config = train_config
        #: each epoch's draws, when set to a list (the tests and the card
        #: check compare them with the JAX package's and the CPU's):
        #: ``{"perm", "starts", "test_starts", "dropout_keys"}``, CPU
        #: tensors
        self.draws: list | None = None
        #: the slots this trainer's fits run on, and on the card their
        #: captured member-epochs (the process's, shared by every trainer)
        self.graphs = EPOCH_GRAPHS

    def _epoch(self, st, store, train_rows, train_y, test_rows, test_y,
               key, phase, batch_size):
        """One epoch of one member (``cnn_trainer.py:188-262``); ``st``
        holds its variables, optimizer and best copies, updated in
        place, and its draws in ``st["draws"]``.  Returns ``(train_loss,
        val_loss, val_f1, improved)`` as 0-dim tensors on the device.  It
        makes no host sync, so ``models/epoch_graph.py`` captures it."""
        cfg = self.config
        n_train, n_test = len(train_rows), len(test_rows)
        n_batches = -(-n_train // batch_size)
        used = n_batches * batch_size
        pad = used - n_train  # < batch_size <= n_train
        dev = store.device
        kperm, kcrop, ktest, kdrop = prng.split(key, 4)
        perm = prng.permutation(kperm, n_train, dev)
        perm = torch.cat([perm, perm[:pad]])  # the zero-weight tail
        rows = train_rows[perm]
        u = prng.uniform(kcrop, (used,), device=dev)
        starts = crop_starts(u, store.lengths[rows], cfg.input_length)
        xs = store.crops_at(rows, starts).reshape(n_batches, batch_size, -1)
        ys = train_y[perm].reshape(n_batches, batch_size, -1)
        ws = torch.cat([torch.ones(n_train, device=dev),
                        torch.zeros(pad, device=dev)]).reshape(
                            n_batches, batch_size)
        dkeys = prng.split(kdrop, n_batches)
        params, stats, opt = st["params"], st["stats"], st["opt"]
        losses = []
        for b in range(n_batches):
            opt.zero_grad(set_to_none=True)
            out, new_stats = short_cnn.apply_train(
                {**params, **stats}, xs[b], dkeys[b], cfg)
            loss = (bce_per_sample(out, ys[b]) * ws[b]).sum() / ws[b].sum()
            with short_cnn.exact_float32():
                loss.backward()
            opt.step()
            stats = {k: t.detach() for k, t in new_stats.items()}
            losses.append(loss.detach())
        st["stats"] = stats
        ut = prng.uniform(ktest, (n_test,), device=dev)
        tstarts = crop_starts(ut, store.lengths[test_rows],
                              cfg.input_length)
        with torch.no_grad():
            preds = short_cnn.apply_infer(
                {**params, **stats}, store.crops_at(test_rows, tstarts), cfg)
            val_loss = bce_loss(preds, test_y)
            val_f1 = weighted_f1_in_graph(preds, test_y)
            # the best-checkpoint gate on the device, no host sync
            score = 1.0 - val_loss
            improved = score > st["best_score"]
            st["best"] = {k: torch.where(improved, t.detach(), st["best"][k])
                          for k, t in {**params, **stats}.items()}
            st["best_score"] = torch.where(improved, score, st["best_score"])
        st["draws"] = {"perm": perm, "starts": starts, "test_starts": tstarts,
                       "dropout_keys": dkeys}
        return torch.stack(losses).mean(), val_loss, val_f1, improved

    def fit(self, variables: dict, store, train_ids, train_y, test_ids,
            test_y, key, *, n_epochs: int | None = None,
            adam_patience: int | None = None, tracer=NULL_TRACER,
            parent=None, user=None, member: int = 0):
        """Train one member with the adam -> sgd best-reload schedule;
        returns ``(best_variables, history)``.  ``train_y``/``test_y``:
        one-hot rows aligned with the id lists.  ``variables`` is copied,
        never changed.  ``adam_patience`` overrides the config's (pre-
        training passes 40); ``None`` or 0 keep it, as in JAX.
        ``tracer``, ``parent``, ``user``, ``member``: the fit's spans
        (module docstring)."""
        cfg = self.train_config
        n_epochs = cfg.n_epochs if n_epochs is None else n_epochs
        adam_patience = adam_patience or cfg.adam_patience
        batch_size = max(1, min(cfg.batch_size, len(train_ids)))
        traced = tracer.enabled
        if traced:
            fit_sp = tracer.begin("retrain.fit", parent=parent,
                                  thread_cpu=True, user=user, member=member)
        dev = store.device
        split = (torch.as_tensor(store.row_of(train_ids), device=dev),
                 torch.as_tensor(train_y, dtype=torch.float32, device=dev),
                 torch.as_tensor(store.row_of(test_ids), device=dev),
                 torch.as_tensor(test_y, dtype=torch.float32, device=dev))
        epochs = []

        def run_epoch(epoch, phase):
            epochs.append((epoch, phase))
            slot.epoch(phase)

        with self.graphs.fit(self, store, variables, *split, key, batch_size,
                             n_epochs, PHASES[0]) as slot:
            run_schedule(n_epochs, adam_patience, cfg.sgd_patience,
                         run_epoch, slot.reload_best)
            # cloned out of the slot before the read, which waits for the
            # clone too: the next fit overwrites the slot
            best = slot.best_copy()
            if traced:
                read_sp = tracer.begin("retrain.read", parent=fit_sp,
                                       thread_cpu=True)
            # one host transfer for the whole history
            vals = slot.history().cpu()
            if traced:
                tracer.end(read_sp)
                tracer.end(fit_sp, graphed=slot.graphed,
                           captured=slot.captured)
            if self.draws is not None:
                self.draws.extend(slot.recorded_draws())
        history = [{"epoch": e, "phase": p, "train_loss": float(v[0]),
                    "val_loss": float(v[1]), "val_f1": float(v[2]),
                    "improved": bool(v[3])}
                   for (e, p), v in zip(epochs, vals)]
        return best, history

    def fit_many(self, variables_list: list, store, train_ids, train_y,
                 test_ids, test_y, key, *, n_epochs: int | None = None,
                 mesh=None, tracer=NULL_TRACER, parent=None, user=None):
        """Train every member, member ``i`` under ``fold_in(key, i)``;
        returns ``(best_variables_list, histories)``.  ``tracer``,
        ``parent``, ``user``: each member's :meth:`fit` spans.

        ``mesh``: a ``(dp, member)`` training mesh.  The member axis spans
        every process's member devices (``L`` a process, ``R`` processes):
        member ``i`` takes slot ``i // ceil(M / (L*R))``, so each slot
        holds a contiguous block of members, as the JAX package's padded
        member axis does.  The process owning a slot trains its members on
        the slot's device, against a copy of the store there; the JAX
        package's padding members only fill the vmap and are not trained.
        Each best copy comes back to the device its member arrived on,
        and across processes each member's result and history are
        broadcast from the rank that trained it, so the ranks hold
        identical committees."""
        from consensus_entropy_tpu_torch.parallel import multihost

        n_members = len(variables_list)
        homes, owners = [None] * n_members, [0] * n_members
        if mesh is not None:
            from consensus_entropy_tpu_torch.parallel.mesh import MEMBER_AXIS

            devices = mesh.axis_devices(MEMBER_AXIS)
            n_slots = len(devices) * multihost.process_count()
            per = -(-n_members // n_slots)
            slots = [i // per for i in range(n_members)]
            homes = [devices[s % len(devices)] for s in slots]
            owners = [s // len(devices) for s in slots]
        me = multihost.process_index()
        best, histories = [], []
        for i, (variables, dev, owner) in enumerate(
                zip(variables_list, homes, owners)):
            b, h = variables, None
            if owner == me:
                b, h = self.fit(variables, _store_on(store, dev), train_ids,
                                train_y, test_ids, test_y,
                                prng.fold_in(key, i), n_epochs=n_epochs,
                                tracer=tracer, parent=parent, user=user,
                                member=i)
            if mesh is not None:
                # in the member's own key order, alike on every rank
                home = next(iter(variables.values())).device
                b = {k: multihost.broadcast_tensor(b[k].to(home), src=owner)
                     for k in variables}
                h = multihost.broadcast_object(h, src=owner)
            best.append(b)
            histories.append(h)
        return best, histories

    def fit_many_users(self, users: list[dict], *,
                       n_epochs: int | None = None, tracer=NULL_TRACER,
                       parent=None) -> list[tuple]:
        """Train U users' committees: the fleet's ``cnn_retrain`` stacked
        dispatch (``committee.CNNRetrainPlan``).  ``users``: one dict per
        user with ``variables_list``, ``store``, ``train_ids`` /
        ``train_y`` / ``test_ids`` / ``test_y`` and the user's ``key``;
        member ``i`` of user ``u`` trains under ``fold_in(users[u]["key"],
        i)``, the stream of that user's own :meth:`fit_many`.  The cohort
        must agree in member count, split sizes and store geometry (the
        plans' group key); a ragged one raises.  Returns ``[(best_variables
        _list, histories), ...]``, one :meth:`fit_many` result per user.
        ``tracer``, ``parent``: every fit's spans, each naming the dict's
        ``user`` where it has one."""
        u0 = users[0]
        shape = (len(u0["variables_list"]), len(u0["train_ids"]),
                 len(u0["test_ids"]), tuple(u0["store"].data.shape))
        for u in users:
            if (len(u["variables_list"]), len(u["train_ids"]),
                    len(u["test_ids"]), tuple(u["store"].data.shape)) \
                    != shape:
                raise ValueError(
                    "fit_many_users cohort is not homogeneous (member "
                    "count / split sizes / store geometry must match; "
                    "group plans by their group_key)")
        return [self.fit_many(u["variables_list"], u["store"],
                              u["train_ids"], u["train_y"], u["test_ids"],
                              u["test_y"], u["key"], n_epochs=n_epochs,
                              tracer=tracer, parent=parent,
                              user=u.get("user"))
                for u in users]
