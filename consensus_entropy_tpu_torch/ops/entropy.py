"""Shannon entropy with ``scipy.stats.entropy`` semantics.

Counterpart of ``consensus_entropy_tpu/ops/entropy.py``: normalise each row
to sum to 1, then return ``-sum(p * log(p))`` in nats with ``0 * log 0 = 0``.
A row that sums to zero gives NaN, as scipy does and as the JAX docstring
states (the JAX function itself returns 0 there).
"""

from __future__ import annotations

import torch


def shannon_entropy(pk: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Entropy of (unnormalised) non-negative distributions along ``dim``."""
    # entr(p) = -p log p, entr(0) = 0, and a 0/0 row stays NaN.
    return torch.special.entr(pk / pk.sum(dim=dim, keepdim=True)).sum(dim=dim)


def masked_entropy(pk: torch.Tensor, valid_mask: torch.Tensor,
                   dim: int = -1, fill: float = float("-inf")) -> torch.Tensor:
    """Entropy per row, with rows where ``valid_mask`` is False set to
    ``fill`` (default ``-inf``) so that top-k never selects them."""
    return torch.where(valid_mask, shannon_entropy(pk, dim=dim), fill)
