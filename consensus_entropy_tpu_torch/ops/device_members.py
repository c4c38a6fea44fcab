"""Closed-form committee members as tensor math (counterpart of
``consensus_entropy_tpu/ops/device_members.py``; only the softmax-linear
member so far)."""

from __future__ import annotations

import torch


def linear_softmax_probs(x: torch.Tensor, coef: torch.Tensor,
                         intercept: torch.Tensor) -> torch.Tensor:
    """Multinomial-logistic probabilities: ``softmax(x @ coef.T + b)``.

    x: ``(N, F)``; coef: ``(C, F)``; intercept: ``(C,)`` -> ``(N, C)``.
    """
    return torch.softmax(x @ coef.T + intercept, dim=-1)
