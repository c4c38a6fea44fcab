"""The acquisition step of every mode: consensus -> entropy -> top-k -> mask.

Counterpart of ``consensus_entropy_tpu/ops/scoring.py``: the single-user
scorers and the fleet families over a leading user axis:

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

Every scorer is written over the trailing axes (members ``-3``, songs
``-2``/``-1``, classes ``-1``), so the same function takes one user's
``(M, N, C)`` table or a cohort's ``(U, M, N, C)`` stack: the fleet families
(:func:`make_fleet_scoring_fns`) are these functions, and each row of a
stacked call is computed by the same ops as that user's single call.
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
    """Mean class distribution over the committee axis of ``(..., M, N,
    C)`` probabilities; ``member_mask`` ``(..., M)`` drops members from the
    mean."""
    if member_mask is None:
        return member_probs.mean(dim=-3)
    w = member_mask.to(member_probs.dtype)[..., None, None]
    return (member_probs * w).sum(dim=-3) / w.sum(dim=-3)


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
    w = torch.where(w.sum(dim=-1, keepdim=True) > 0, w, torch.ones_like(w))
    scale = w * (p.shape[-3] / w.sum(dim=-1, keepdim=True))
    return (p * scale[..., None, None]).mean(dim=-3)


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
    stacked = torch.cat([consensus_mean(member_probs, member_mask), hc_freq],
                        dim=-2)
    stacked_mask = torch.cat([pool_mask, hc_mask], dim=-1)
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
    as ``jax.random.uniform``), drawn on the mask's device.  A ``(U, 2)``
    key batch with ``(U, N)`` masks draws each row under its own key."""
    if key.dim() == 2:
        scores = prng.uniform_rows(key, pool_mask.shape[-1],
                                   device=pool_mask.device)
    else:
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


#: fn key -> (pool-mask position, hc-mask position or None) of a fused
#: step's inputs: the masks it updates in place (the operands the JAX
#: ``FUSED_DONATE`` donates), which its result's ``pool_mask`` /
#: ``hc_mask`` are.  After a stacked call the scheduler copies each user's
#: row back into that user's own mask tensors.
FUSED_MASKS = {"mc_fused": (1, None), "qbdc_fused": (1, None),
               "wmc_fused": (1, None), "rand_fused": (1, None),
               "hc_pre_fused": (2, 1), "mix_fused": (1, 3)}

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


def make_fleet_scoring_fns(*, k: int,
                           tie_break: str = "fast") -> dict[str, Callable]:
    """The scorers over a leading USER axis (the JAX
    ``make_fleet_scoring_fns``): mc ``(U, M, N, C), (U, N)``; hc / hc_pre
    ``(U, N[, C]), (U, N)``; mix ``(U, M, N, C), (U, N), (U, N, C), (U,
    N)``; rand ``(U, 2)`` keys (:func:`stack_user_keys`), ``(U, N)``; the
    ``*_masked`` variants also take a ``(U, M)`` member mask.  One call
    scores a cohort of same-shaped pools; each row is that user's single
    call (the functions are the same, see the module docstring), and the
    fused keys clear the selected rows of the stacked masks in place."""
    def mc(probs, pool_mask):
        return score_mc(probs, pool_mask, k=k, tie_break=tie_break)

    def mc_masked(probs, pool_mask, member_mask):
        return score_mc(probs, pool_mask, k=k, member_mask=member_mask,
                        tie_break=tie_break)

    def mix(probs, pool_mask, hc_freq, hc_mask):
        return score_mix(probs, pool_mask, hc_freq, hc_mask, k=k,
                         tie_break=tie_break)

    def mix_masked(probs, pool_mask, hc_freq, hc_mask, member_mask):
        return score_mix(probs, pool_mask, hc_freq, hc_mask, k=k,
                         member_mask=member_mask, tie_break=tie_break)

    def wmc_masked(probs, pool_mask, weights, member_mask):
        return score_wmc(probs, pool_mask, weights, k=k,
                         member_mask=member_mask, tie_break=tie_break)

    fns = make_scoring_fns(k=k, tie_break=tie_break)
    fns.update(mc=mc, mc_masked=mc_masked, mix=mix, mix_masked=mix_masked,
               wmc_masked=wmc_masked)
    return fns


#: which positional operand of each fleet scorer carries the ``(U, N)``
#: pool mask, whose trailing axis is the padded pool width
_POOL_MASK_POS = {"mc": 1, "mc_masked": 1, "hc": 1, "hc_pre": 1,
                  "mix": 1, "mix_masked": 1, "rand": 1, "qbdc": 1,
                  "wmc": 1, "wmc_masked": 1, "mc_fused": 1,
                  "qbdc_fused": 1, "wmc_fused": 1, "rand_fused": 1,
                  "hc_pre_fused": 1, "mix_fused": 1}


def fleet_scoring_fns_for_width(*, k: int, tie_break: str = "fast",
                                width: int) -> dict[str, Callable]:
    """The fleet scorers for one padded pool ``width`` (a serve bucket):
    every call checks that the pool-mask operand's trailing axis is
    ``width``, so a session routed to the wrong bucket fails at dispatch
    instead of being scored in another bucket's cohort."""
    def guarded(fn_key, fn):
        pos = _POOL_MASK_POS[fn_key]

        def call(*args):
            got = args[pos].shape[-1]
            if got != width:
                raise ValueError(
                    f"bucket routing error: {fn_key!r} scorer for pool "
                    f"width {width} got inputs of width {got}")
            return fn(*args)

        return call

    return {key: guarded(key, fn) for key, fn in make_fleet_scoring_fns(
        k=k, tie_break=tie_break).items()}


def stack_user_keys(keys) -> torch.Tensor:
    """Per-user ``(2,)`` keys -> one ``(U, 2)`` key batch for the fleet
    ``rand`` scorers."""
    return torch.stack([prng.key_data(k) for k in keys])


def is_key_array(x) -> bool:
    """True for a port key (batch): ``(..., 2)`` uint32 words."""
    return (isinstance(x, torch.Tensor) and x.dtype == torch.uint32
            and x.shape[-1:] == (2,))
