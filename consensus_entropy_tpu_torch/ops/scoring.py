"""The mc acquisition step: consensus mean -> entropy -> top-k -> mask.

Counterpart of the mc part of ``consensus_entropy_tpu/ops/scoring.py``
(``amg_test.py:425-447`` semantics).  The pool axis keeps a fixed ``N`` and a
boolean ``pool_mask``; shrinking the pool only clears mask bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from consensus_entropy_tpu_torch.ops.entropy import masked_entropy
from consensus_entropy_tpu_torch.ops.topk import masked_top_k, reveal_mask_update


class ScoreResult(NamedTuple):
    """One scoring pass: per-row masked entropy (``-inf`` on invalid rows)
    and the top-k ``values`` / ``indices``."""

    entropy: torch.Tensor
    values: torch.Tensor
    indices: torch.Tensor


class FusedStepResult(NamedTuple):
    """One fused step: the :class:`ScoreResult` fields plus the post-select
    ``pool_mask`` — the caller's mask tensor, updated in place."""

    entropy: torch.Tensor
    values: torch.Tensor
    indices: torch.Tensor
    pool_mask: torch.Tensor


def consensus_mean(member_probs: torch.Tensor,
                   member_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean class distribution over the committee axis of ``(M, N, C)``
    probabilities; ``member_mask`` ``(M,)`` drops members from the mean."""
    if member_mask is None:
        return member_probs.mean(dim=0)
    w = member_mask.to(member_probs.dtype)[:, None, None]
    return (member_probs * w).sum(dim=0) / w.sum()


def score_mc(member_probs: torch.Tensor, pool_mask: torch.Tensor, *, k: int,
             member_mask: torch.Tensor | None = None,
             tie_break: str = "fast") -> ScoreResult:
    """Machine-consensus acquisition: mean -> entropy -> top-k."""
    ent = masked_entropy(consensus_mean(member_probs, member_mask), pool_mask)
    values, indices = masked_top_k(ent, pool_mask, k, tie_break)
    return ScoreResult(ent, values, indices)


def fused_mc(member_probs: torch.Tensor, pool_mask: torch.Tensor, *, k: int,
             member_mask: torch.Tensor | None = None,
             tie_break: str = "fast") -> FusedStepResult:
    """:func:`score_mc` followed by the in-place shrink of ``pool_mask``."""
    r = score_mc(member_probs, pool_mask, k=k, member_mask=member_mask,
                 tie_break=tie_break)
    return FusedStepResult(r.entropy, r.values, r.indices,
                           reveal_mask_update(pool_mask, r.values, r.indices))
