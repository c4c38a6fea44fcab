"""mc acquisition over a device-resident pool and a softmax-linear committee.

Counterpart of the iteration bodies of ``bench.py::build_pallas_impl``
(single device) and ``build_xla_impl`` in mc mode, with ``fused_mc``'s mask
shrink: per AL iteration, one fused select — consensus-entropy kernel ->
top-k -> in-place reveal of the pool mask.  The member weights stay fixed
across iterations, as the bench holds them; retraining members is host
work outside this class.
"""

from __future__ import annotations

import numpy as np
import torch

from consensus_entropy_tpu_torch.convert import linear_members_from_jax
from consensus_entropy_tpu_torch.device import resolve_device
from consensus_entropy_tpu_torch.kernels import linear_mc
from consensus_entropy_tpu_torch.ops.scoring import FusedStepResult
from consensus_entropy_tpu_torch.ops.topk import masked_top_k, reveal_mask_update


class LinearPoolScorer:
    """The pool ``x`` ``(N, K, F)`` and members ``w`` ``(M, F, C)`` /
    ``b`` ``(M, C)`` (numpy, JAX layout) move to ``device`` once; the pool
    mask lives there too and only shrinks.

    ``impl='kernel'`` scores through :func:`linear_mc.linear_score_mc` with
    the top-k fused into the kernel (which, on a CPU device, runs the plain
    version); ``impl='plain'`` runs the plain version on any device — the
    reference the kernel is held against.
    """

    def __init__(self, x, w, b, *, device=None, impl: str = "kernel"):
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.device = resolve_device(device)
        self.impl = impl
        self.n_members = int(np.shape(w)[0])
        self.x = torch.from_numpy(
            np.ascontiguousarray(x, np.float32)).to(self.device)
        self.w_packed, self.b_packed = linear_members_from_jax(w, b,
                                                               self.device)
        self.pool_mask = torch.ones(self.x.shape[0], dtype=torch.bool,
                                    device=self.device)
        linear_mc.validate(self.x, self.w_packed, self.b_packed,
                           self.pool_mask, self.n_members)

    def step(self, k: int) -> FusedStepResult:
        """Select the ``k`` highest-entropy songs still in the pool and clear
        them from ``pool_mask`` (in place).  Slots with value ``-inf`` (fewer
        than ``k`` songs left) select nothing."""
        if self.impl == "kernel":
            ent, values, indices = linear_mc.linear_score_mc(
                self.x, self.w_packed, self.b_packed, self.pool_mask,
                n_members=self.n_members, k=k, fuse_topk=True)
        else:
            ent = linear_mc.plain_masked_entropy(
                self.x, self.w_packed, self.b_packed, self.pool_mask,
                self.n_members)
            values, indices = masked_top_k(ent, self.pool_mask, k)
        return FusedStepResult(
            ent, values, indices,
            reveal_mask_update(self.pool_mask, values, indices))

    def run(self, iterations: int, k: int):
        """``iterations`` steps; returns each step's ``(indices, values)``
        as numpy arrays."""
        out = []
        for _ in range(iterations):
            r = self.step(k)
            out.append((r.indices.cpu().numpy(), r.values.cpu().numpy()))
        return out
