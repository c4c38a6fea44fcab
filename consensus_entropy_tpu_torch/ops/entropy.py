"""Shannon entropy with ``scipy.stats.entropy`` semantics.

Counterpart of ``consensus_entropy_tpu/ops/entropy.py``: normalise each row
to sum to 1, then return ``-sum(p * log(p))`` in nats with ``0 * log 0 = 0``.
A row that sums to zero gives 0, as the JAX function does (its 0/0 NaN fails
``p > 0``), and as the CUDA kernel does; scipy gives NaN there.
"""

from __future__ import annotations

import torch


def shannon_entropy(pk: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Entropy of (unnormalised) non-negative distributions along ``dim``."""
    p = pk / pk.sum(dim=dim, keepdim=True)
    live = p > 0        # False for 0 and for the NaN of a zero-sum row
    plogp = torch.where(live, p * torch.log(torch.where(live, p, 1.0)), 0.0)
    return -plogp.sum(dim=dim)


def masked_entropy(pk: torch.Tensor, valid_mask: torch.Tensor,
                   dim: int = -1, fill: float = float("-inf")) -> torch.Tensor:
    """Entropy per row, with rows where ``valid_mask`` is False set to
    ``fill`` (default ``-inf``) so that top-k never selects them."""
    return torch.where(valid_mask, shannon_entropy(pk, dim=dim), fill)
