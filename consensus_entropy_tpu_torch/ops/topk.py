"""Masked top-k with the reference's tie policies, and the mask shrink.

Counterpart of ``consensus_entropy_tpu/ops/topk.py``.  Two deterministic
tie policies (identical on distinct scores):

- ``'fast'``  — ``lax.top_k``: the lowest index wins ties.  ``torch.topk``
  leaves the order of ties unspecified (it returns ``[2, 4, 1]`` for
  ``top-3 of [1, 3, 3, 2, 3]`` on the CPU), so this is a stable descending
  sort, which returns ``[1, 2, 4]``.
- ``'numpy'`` — ``np.argsort(scores, kind='stable')[::-1][:k]``: the
  highest index wins ties.
"""

from __future__ import annotations

import torch


def masked_top_k(scores: torch.Tensor, valid_mask: torch.Tensor, k: int,
                 tie_break: str = "fast"):
    """Top-``k`` ``(values, indices)`` of ``scores`` restricted to
    ``valid_mask``, along the last axis (leading axes, such as the fleet's
    user axis, are independent rows).

    Masked entries count as ``-inf`` and rank last; with fewer than ``k``
    valid entries the trailing values are ``-inf`` and their indices carry
    no meaning (gate on ``values > -inf``, see :func:`valid_count`).
    """
    masked = torch.where(valid_mask, scores, float("-inf"))
    if tie_break == "fast":
        order = torch.sort(masked, dim=-1, descending=True,
                           stable=True).indices
    elif tie_break == "numpy":
        order = torch.sort(masked, dim=-1, stable=True).indices.flip(-1)
    else:
        raise ValueError(f"unknown tie_break: {tie_break!r}")
    idx = order[..., :k]
    return masked.gather(-1, idx), idx


def valid_count(values: torch.Tensor) -> torch.Tensor:
    """How many of the returned top-k slots hold real (unmasked) rows."""
    return (values > float("-inf")).sum()


def reveal_mask_update(mask: torch.Tensor, values: torch.Tensor,
                       indices: torch.Tensor) -> torch.Tensor:
    """Clear the just-selected rows of ``mask`` IN PLACE and return it.

    The JAX version returns a new array that reuses the donated input
    buffer; here the caller's tensor itself changes.  Slots whose value is
    ``-inf`` (fewer than k valid rows remained) carry meaningless indices
    and are ignored.  Clearing an already-False row is idempotent.  Leading
    axes are rows, each clearing its own indices.
    """
    live = (values > float("-inf")).nonzero(as_tuple=True)
    mask[live[:-1] + (indices[live],)] = False
    return mask
