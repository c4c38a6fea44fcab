"""The acquisition step of every mode: consensus -> entropy -> top-k -> mask.

Counterpart of ``consensus_entropy_tpu/ops/scoring.py`` (the single-user
scorers; the fleet families come with the fleet):

- **mc** (``amg_test.py:425-447``): mean of the committee's probabilities,
  entropy, top-k; **qbdc** is the same reduction over K dropout forwards;
  **wmc** weighs the members first.
- **hc** (``amg_test.py:449-455``): entropy of the human-consensus rows.
- **mix** (``amg_test.py:457-484``): one ranking over the stacked
  ``[mc consensus; hc rows]``, indices in ``[0, 2N)``.
- **rand** (``amg_test.py:486-489``): top-k over threefry uniform scores.

The pool axis keeps a fixed ``N`` and a boolean ``pool_mask``; shrinking the
pool only clears mask bits.  The ``fused_*`` steps clear the selected rows of
the masks they are given IN PLACE (where the JAX package donates the mask
buffers) and return those same tensors.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.ops.entropy import masked_entropy
from consensus_entropy_tpu_torch.ops.topk import masked_top_k, reveal_mask_update


class ScoreResult(NamedTuple):
    """One scoring pass: per-row masked entropy (``-inf`` on invalid rows)
    and the top-k ``values`` / ``indices``.  For mix the rows are
    ``[mc (N); hc (N)]``: see :func:`split_mix_index`."""

    entropy: torch.Tensor
    values: torch.Tensor
    indices: torch.Tensor


class FusedStepResult(NamedTuple):
    """One fused step: the :class:`ScoreResult` fields plus the post-select
    ``pool_mask`` (and ``hc_mask`` for the hc-table modes, else ``None``) —
    the caller's mask tensors, updated in place."""

    entropy: torch.Tensor
    values: torch.Tensor
    indices: torch.Tensor
    pool_mask: torch.Tensor
    hc_mask: torch.Tensor | None = None


def consensus_mean(member_probs: torch.Tensor,
                   member_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean class distribution over the committee axis of ``(M, N, C)``
    probabilities; ``member_mask`` ``(M,)`` drops members from the mean."""
    if member_mask is None:
        return member_probs.mean(dim=0)
    w = member_mask.to(member_probs.dtype)[:, None, None]
    return (member_probs * w).sum(dim=0) / w.sum()


def weighted_consensus_mean(member_probs: torch.Tensor,
                            member_weights: torch.Tensor,
                            member_mask: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Reliability-weighted consensus ``sum_m w_m p_m / sum_m w_m``.

    The member mask zeroes a weight before the renormalisation, and an
    all-zero weight vector falls back to uniform (= mc).  Written as
    ``mean(p * w*M/sum(w))``, as the JAX function is: with unit weights the
    scale is exactly 1.0 and the reduction is :func:`consensus_mean`'s, so
    equal-weight wmc is bit-identical to mc.
    """
    p = member_probs
    w = member_weights.to(p.dtype)
    if member_mask is not None:
        w = w * member_mask.to(p.dtype)
    w = torch.where(w.sum() > 0, w, torch.ones_like(w))
    scale = w * (p.shape[0] / w.sum())
    return (p * scale[:, None, None]).mean(dim=0)


def score_mc(member_probs: torch.Tensor, pool_mask: torch.Tensor, *, k: int,
             member_mask: torch.Tensor | None = None,
             tie_break: str = "fast") -> ScoreResult:
    """Machine-consensus acquisition: mean -> entropy -> top-k."""
    ent = masked_entropy(consensus_mean(member_probs, member_mask), pool_mask)
    values, indices = masked_top_k(ent, pool_mask, k, tie_break)
    return ScoreResult(ent, values, indices)


def score_wmc(member_probs: torch.Tensor, pool_mask: torch.Tensor,
              member_weights: torch.Tensor, *, k: int,
              member_mask: torch.Tensor | None = None,
              tie_break: str = "fast") -> ScoreResult:
    """Weighted machine consensus: weighted mean -> entropy -> top-k."""
    ent = masked_entropy(
        weighted_consensus_mean(member_probs, member_weights, member_mask),
        pool_mask)
    values, indices = masked_top_k(ent, pool_mask, k, tie_break)
    return ScoreResult(ent, values, indices)


#: qbdc shares mc's reduction: its committee axis holds K dropout forwards
#: of one network instead of M stored models.
score_qbdc = score_mc


def score_hc(hc_freq: torch.Tensor, hc_mask: torch.Tensor, *, k: int,
             tie_break: str = "fast") -> ScoreResult:
    """Human-consensus acquisition: entropy of annotator-frequency rows."""
    ent = masked_entropy(hc_freq, hc_mask)
    values, indices = masked_top_k(ent, hc_mask, k, tie_break)
    return ScoreResult(ent, values, indices)


def score_hc_precomputed(hc_ent: torch.Tensor, hc_mask: torch.Tensor, *,
                         k: int, tie_break: str = "fast") -> ScoreResult:
    """hc over row entropies computed once (the table never changes, only
    its mask shrinks): a masked top-k."""
    ent = torch.where(hc_mask, hc_ent, float("-inf"))
    values, indices = masked_top_k(ent, hc_mask, k, tie_break)
    return ScoreResult(ent, values, indices)


def score_mix(member_probs: torch.Tensor, pool_mask: torch.Tensor,
              hc_freq: torch.Tensor, hc_mask: torch.Tensor, *, k: int,
              member_mask: torch.Tensor | None = None,
              tie_break: str = "fast") -> ScoreResult:
    """Hybrid acquisition: entropy over stacked ``[mc consensus; hc rows]``.
    A song can surface from both blocks, as in the reference."""
    stacked = torch.cat([consensus_mean(member_probs, member_mask), hc_freq])
    stacked_mask = torch.cat([pool_mask, hc_mask])
    ent = masked_entropy(stacked, stacked_mask)
    values, indices = masked_top_k(ent, stacked_mask, k, tie_break)
    return ScoreResult(ent, values, indices)


def split_mix_index(indices: torch.Tensor, n_pool: int):
    """Mix-space row indices -> ``(is_hc_block, song_slot)``."""
    is_hc = indices >= n_pool
    return is_hc, torch.where(is_hc, indices - n_pool, indices)


def selection_scalars(x) -> np.ndarray:
    """The one device->host pull of a select: the k indices or values that
    ``Acquirer.finish_select`` maps back to song ids."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def score_rand(key: torch.Tensor, pool_mask: torch.Tensor, *,
               k: int) -> ScoreResult:
    """Random baseline: top-k over threefry uniform scores (the same draws
    as ``jax.random.uniform``), drawn on the mask's device."""
    scores = prng.uniform(key, tuple(pool_mask.shape),
                          device=pool_mask.device)
    values, indices = masked_top_k(scores, pool_mask, k, "fast")
    return ScoreResult(scores, values, indices)


def fused_mc(member_probs: torch.Tensor, pool_mask: torch.Tensor, *, k: int,
             member_mask: torch.Tensor | None = None,
             tie_break: str = "fast") -> FusedStepResult:
    """:func:`score_mc` followed by the in-place shrink of ``pool_mask``."""
    r = score_mc(member_probs, pool_mask, k=k, member_mask=member_mask,
                 tie_break=tie_break)
    return FusedStepResult(r.entropy, r.values, r.indices,
                           reveal_mask_update(pool_mask, r.values, r.indices))


def fused_wmc(member_probs: torch.Tensor, pool_mask: torch.Tensor,
              member_weights: torch.Tensor, *, k: int,
              member_mask: torch.Tensor | None = None,
              tie_break: str = "fast") -> FusedStepResult:
    r = score_wmc(member_probs, pool_mask, member_weights, k=k,
                  member_mask=member_mask, tie_break=tie_break)
    return FusedStepResult(r.entropy, r.values, r.indices,
                           reveal_mask_update(pool_mask, r.values, r.indices))


fused_qbdc = fused_mc


def fused_hc_pre(hc_ent: torch.Tensor, hc_mask: torch.Tensor,
                 pool_mask: torch.Tensor, *, k: int,
                 tie_break: str = "fast") -> FusedStepResult:
    """hc over the hoisted entropies, then both masks shrink: the queried
    rows leave the hc table and the pool.  ``pool_mask`` is not read by the
    ranking; it is updated so the device twin keeps step with the host."""
    r = score_hc_precomputed(hc_ent, hc_mask, k=k, tie_break=tie_break)
    return FusedStepResult(
        r.entropy, r.values, r.indices,
        reveal_mask_update(pool_mask, r.values, r.indices),
        reveal_mask_update(hc_mask, r.values, r.indices))


def fused_mix(member_probs: torch.Tensor, pool_mask: torch.Tensor,
              hc_freq: torch.Tensor, hc_mask: torch.Tensor, *, k: int,
              member_mask: torch.Tensor | None = None,
              tie_break: str = "fast") -> FusedStepResult:
    """mix, with each winner folded back to its song slot and both masks
    cleared there, whichever block surfaced it (a song from both blocks is
    cleared twice, which is idempotent)."""
    r = score_mix(member_probs, pool_mask, hc_freq, hc_mask, k=k,
                  member_mask=member_mask, tie_break=tie_break)
    _, slots = split_mix_index(r.indices, pool_mask.shape[-1])
    return FusedStepResult(
        r.entropy, r.values, r.indices,
        reveal_mask_update(pool_mask, r.values, slots),
        reveal_mask_update(hc_mask, r.values, slots))


def fused_rand(key: torch.Tensor, pool_mask: torch.Tensor, *,
               k: int) -> FusedStepResult:
    r = score_rand(key, pool_mask, k=k)
    return FusedStepResult(r.entropy, r.values, r.indices,
                           reveal_mask_update(pool_mask, r.values, r.indices))


_UNFUSED = {"mc": score_mc, "hc": score_hc, "hc_pre": score_hc_precomputed,
            "mix": score_mix, "qbdc": score_qbdc, "wmc": score_wmc}
_FUSED = {"mc_fused": fused_mc, "qbdc_fused": fused_qbdc,
          "wmc_fused": fused_wmc, "hc_pre_fused": fused_hc_pre,
          "mix_fused": fused_mix}


def make_scoring_fns(*, k: int,
                     tie_break: str = "fast") -> dict[str, Callable]:
    """The scorers with ``k`` (and the tie policy; rand has none) bound:
    ``mc``, ``hc``, ``hc_pre``, ``mix``, ``rand``, ``qbdc``, ``wmc`` and the
    six ``*_fused`` steps, the keys of the JAX ``make_scoring_fns``."""
    fns = {key: functools.partial(fn, k=k, tie_break=tie_break)
           for key, fn in {**_UNFUSED, **_FUSED}.items()}
    fns["rand"] = functools.partial(score_rand, k=k)
    fns["rand_fused"] = functools.partial(fused_rand, k=k)
    return fns
