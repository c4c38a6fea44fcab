"""Faults planted in the timed path, to show that ``correct`` sees them.

Each fault is a context manager that breaks one part of the system under
test while a run goes on underneath it:

- ``unchanged_retrain``: the CNN retrain returns each member's state
  unchanged;
- ``half_batch``: the retrain's loss is the mean over the first half of
  each batch, the rest left out;
- ``fewer_epochs``: the retrain runs one epoch, not the configuration's;
- ``last_epoch``: the retrain keeps its last epoch, not its best;
- ``half_mean``: the committee's consensus mean is taken over the first
  half of its members, the rest left out;
- ``altered_answer``: the last song of each selection is swapped for a
  live song the selection passed over, where the selection is produced;
- ``skipped_update``: the host members' update does nothing;
- ``gnb_restart``: each GaussianNB update forgets the rows before it;
- ``sgd_restart``: each SGD update restarts the learning-rate schedule;
- ``gbdt_no_lambda``: each boosted-tree update grows its new trees with
  no L2 term in the leaves and the gains.

A run on one card has no exchange between chips to leave out.  The CPU
tests plant each fault in a small run; ``benchmark.check``'s control
readings plant the retrain's and the host updates' faults in the
reference put in the system's place, at a cell's own size on the card.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def unchanged_retrain():
    from consensus_entropy_tpu_torch.models.cnn_trainer import CNNTrainer

    def make(orig):
        def fit(self, variables, *a, **kw):
            _, history = orig(self, variables, *a, **kw)
            return {k: t.detach().clone() for k, t in variables.items()}, \
                history
        return fit
    return _patched(CNNTrainer, "fit", make)


def half_mean():
    from consensus_entropy_tpu_torch.ops import scoring

    def make(orig):
        def consensus_mean(member_probs, member_mask=None):
            half = max(1, member_probs.shape[-3] // 2)
            return orig(member_probs[..., :half, :, :],
                        None if member_mask is None
                        else member_mask[..., :half])
        return consensus_mean
    return _patched(scoring, "consensus_mean", make)


def altered_answer():
    from consensus_entropy_tpu_torch.al.acquisition import Acquirer

    def make(orig):
        def finish_select(self, res):
            picks = orig(self, res)
            spare = [s for s in self.remaining_songs if s not in picks]
            if picks and spare:
                picks = picks[:-1] + [spare[0]]
            return picks
        return finish_select
    return _patched(Acquirer, "finish_select", make)


def skipped_update():
    from consensus_entropy_tpu_torch.models.committee import Committee

    return _patched(Committee, "update_host",
                    lambda orig: lambda self, X, y: None)


def half_batch():
    import torch

    from consensus_entropy_tpu_torch.models import cnn_trainer

    def make(orig):
        def bce_per_sample(preds, targets):
            loss = orig(preds, targets)
            if not torch.is_grad_enabled() or loss.shape[0] < 2:
                return loss  # the evaluation's loss stays whole
            n, keep = loss.shape[0], -(-loss.shape[0] // 2)
            scale = torch.zeros_like(loss)
            scale[:keep] = n / keep
            return loss * scale
        return bce_per_sample
    return _patched(cnn_trainer, "bce_per_sample", make)


def fewer_epochs():
    from consensus_entropy_tpu_torch.models.cnn_trainer import CNNTrainer

    def make(orig):
        def fit(self, *a, **kw):
            return orig(self, *a, **{**kw, "n_epochs": 1})
        return fit
    return _patched(CNNTrainer, "fit", make)


def last_epoch():
    from consensus_entropy_tpu_torch.models.cnn_trainer import CNNTrainer

    def make(orig):
        def _epoch(self, st, *a, **kw):
            out = orig(self, st, *a, **kw)
            st["best"] = {k: t.detach().clone() for k, t in
                          {**st["params"], **st["stats"]}.items()}
            return out
        return _epoch
    return _patched(CNNTrainer, "_epoch", make)


def gnb_restart():
    from consensus_entropy_tpu_torch.models.members import GNBMember

    def make(orig):
        def update(self, X, y):
            self.class_count_ = self.class_count_ * 0
            return orig(self, X, y)
        return update
    return _patched(GNBMember, "update", make)


def sgd_restart():
    from consensus_entropy_tpu_torch.models.members import SGDMember

    def make(orig):
        def update(self, X, y):
            self.t_ = 1.0
            return orig(self, X, y)
        return update
    return _patched(SGDMember, "update", make)


def gbdt_no_lambda():
    from consensus_entropy_tpu_torch.models.gbdt import NativeGBDTMember

    def make(orig):
        def update(self, X, y):
            lam, self.model.lam = self.model.lam, 0.0
            try:
                return orig(self, X, y)
            finally:
                self.model.lam = lam
        return update
    return _patched(NativeGBDTMember, "update", make)


FAULTS = {"unchanged_retrain": unchanged_retrain, "half_batch": half_batch,
          "fewer_epochs": fewer_epochs, "last_epoch": last_epoch,
          "half_mean": half_mean, "altered_answer": altered_answer,
          "skipped_update": skipped_update, "gnb_restart": gnb_restart,
          "sgd_restart": sgd_restart, "gbdt_no_lambda": gbdt_no_lambda}


@contextlib.contextmanager
def planted(names):
    """Every fault in ``names`` at once."""
    with contextlib.ExitStack() as stack:
        for n in names:
            stack.enter_context(FAULTS[n]())
        yield
