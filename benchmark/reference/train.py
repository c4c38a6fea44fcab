"""A CNN member's retrain, in plain PyTorch.

A frozen copy of the schedule the committee retrains its CNN members
with (``amg_test.py``'s loop as the JAX port runs it), for as many epochs
as its Adam phase lasts: each epoch draws a permutation of the train
songs (a zero-weight tail fills the last batch), one random crop a song
and a dropout mask a batch, takes one Adam step a batch (lr 1e-4,
coupled weight decay 1e-4) on the per-sample BCE weighted over the
batch, then scores one random crop of each test song; the variables of
the best epoch by ``1 - val_loss`` (which starts at 0) are kept.  The
draws come from ``reference.prng`` in the JAX order: per epoch ``key, sub
= split(key)``, ``kperm, kcrop, ktest, kdrop = split(sub, 4)``, member
``i`` under ``fold_in(key, i)``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import prng
from benchmark.reference.trunk import TrunkConfig, forward, is_stat, precision

#: the Flax module path and call count of the one dropout layer's key
DROPOUT_PATH = ("Dropout_0", 1)


def bce_per_sample(p, y):
    p = torch.clamp(p, 0.0, 1.0)
    log_p = torch.clamp(torch.log(torch.clamp(p, min=1e-44)), min=-100.0)
    log_q = torch.clamp(torch.log(torch.clamp(1.0 - p, min=1e-44)),
                        min=-100.0)
    return -torch.mean(y * log_p + (1.0 - y) * log_q, dim=-1)


def crops(data: torch.Tensor, rows, u: np.ndarray, input_length: int,
          lengths) -> torch.Tensor:
    """``(len(rows), L)`` crops starting at ``floor(u * (len - L))``,
    taken in float32."""
    span = (np.asarray(lengths, np.int64)[rows] - input_length).astype(
        np.float32)
    starts = np.floor(u * span).astype(np.int64)
    idx = (torch.as_tensor(starts, device=data.device)[:, None]
           + torch.arange(input_length, device=data.device)[None, :])
    return data[torch.as_tensor(np.asarray(rows), device=data.device)[:,
                                                                      None],
                idx]


def fit(variables: dict, data: torch.Tensor, lengths, train_rows, train_y,
        test_rows, test_y, key, cfg: TrunkConfig, *, n_epochs: int,
        batch_size: int = 5, lr: float = 1e-4, weight_decay: float = 1e-4,
        tf32: bool = False, trajectory: list | None = None,
        half_batch: bool = False):
    """One member: ``(best variables, {leaf: first gradient's norm})``.
    ``trajectory``: a list that gets each epoch's ``(score, variables)``.
    ``half_batch``: the loss is the mean over the first half of each batch
    (a planted fault's reading)."""
    dev = data.device
    train_rows, test_rows = np.asarray(train_rows), np.asarray(test_rows)
    train_y = torch.as_tensor(np.asarray(train_y), dtype=torch.float32,
                              device=dev)
    test_y = torch.as_tensor(np.asarray(test_y), dtype=torch.float32,
                             device=dev)
    n_train, n_test = len(train_rows), len(test_rows)
    bs = max(1, min(batch_size, n_train))
    n_batches = -(-n_train // bs)
    used = n_batches * bs
    params = {k: t.detach().clone().requires_grad_(True)
              for k, t in variables.items() if not is_stat(k)}
    stats = {k: t.detach().clone() for k, t in variables.items()
             if is_stat(k)}
    opt = torch.optim.Adam(list(params.values()), lr=lr,
                           weight_decay=weight_decay)
    best = {k: t.detach().clone() for k, t in {**params, **stats}.items()}
    best_score = 0.0
    first_grad = None
    keep = 1.0 - cfg.dropout_rate
    for _ in range(n_epochs):
        key, sub = prng.split(key)
        kperm, kcrop, ktest, kdrop = prng.split(sub, 4)
        perm = prng.permutation(kperm, n_train)
        perm = np.concatenate([perm, perm[: used - n_train]])
        xs = crops(data, train_rows[perm], prng.uniform(kcrop, used),
                   cfg.input_length, lengths)
        ys = train_y[torch.as_tensor(perm, device=dev)]
        ws = torch.cat([torch.ones(n_train, device=dev),
                        torch.zeros(used - n_train, device=dev)])
        dkeys = prng.split(kdrop, n_batches)
        for b in range(n_batches):
            sl = slice(b * bs, (b + 1) * bs)
            opt.zero_grad(set_to_none=True)
            d = cfg.widths[-1]
            mask = prng.bernoulli(prng.fold_in_static(dkeys[b],
                                                      *DROPOUT_PATH),
                                  keep, bs * d).reshape(bs, d)
            out, new_stats = forward(
                {**params, **stats}, xs[sl], cfg, train=True,
                drop_keep=torch.as_tensor(mask, device=dev), tf32=tf32)
            w = ws[sl]
            if half_batch:
                w = torch.cat([w[: -(-bs // 2)], 0 * w[-(-bs // 2):]])
            loss = (bce_per_sample(out, ys[sl]) * w).sum() / w.sum()
            with precision(tf32):
                loss.backward()
            if first_grad is None:
                first_grad = {k: float(t.grad.norm())
                              for k, t in params.items()}
            opt.step()
            stats = {k: t.detach() for k, t in new_stats.items()}
        u = prng.uniform(ktest, n_test)
        with torch.no_grad():
            preds = forward({**params, **stats},
                            crops(data, test_rows, u, cfg.input_length,
                                  lengths), cfg, tf32=tf32)[0]
            score = float(1.0 - bce_per_sample(preds, test_y).mean())
        if trajectory is not None:
            trajectory.append((score, {k: t.detach().clone() for k, t in
                                       {**params, **stats}.items()}))
        if score > best_score:
            best_score = score
            best = {k: t.detach().clone()
                    for k, t in {**params, **stats}.items()}
    return best, first_grad


def fit_committee(member_variables: list, data, lengths, train_rows,
                  train_y, test_rows, test_y, key, cfg: TrunkConfig,
                  **kw) -> list:
    """Every member, member ``i`` under ``fold_in(key, i)``."""
    return [fit(v, data, lengths, train_rows, train_y, test_rows, test_y,
                prng.fold_in(key, i), cfg, **kw)
            for i, v in enumerate(member_variables)]
