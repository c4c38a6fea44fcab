"""wmc — weighted machine consensus (arxiv 2011.06086, 2012.01988).

Counterpart of ``consensus_entropy_tpu/acquire/wmc.py``: the consensus mean
weighs each member by its reliability (``ops.scoring.
weighted_consensus_mean``).  Weights start uniform, which is exactly mc;
the AL loop updates them from post-reveal agreement and sets
``Acquirer.member_weights`` before each select.
"""

from __future__ import annotations

import numpy as np
import torch

from consensus_entropy_tpu_torch.acquire.base import (
    AcquisitionStrategy,
    sanitize_member_rows,
)


class WeightedMachineConsensus(AcquisitionStrategy):
    name = "wmc"
    needs_probs = True
    uses_weights = True

    def scoring_inputs(self, acq, member_probs=None, *, rand_key=None):
        staged, w = self._staged(acq, member_probs)
        return "wmc", (staged, acq._feed(acq.pool_mask), w)

    def fused_inputs(self, acq, member_probs=None, *, rand_key=None):
        staged, w = self._staged(acq, member_probs)
        return "wmc_fused", (staged, acq.device_masks().pool_mask, w)

    @staticmethod
    def _staged(acq, member_probs):
        staged = sanitize_member_rows(acq._staged_probs(member_probs))
        m = staged.shape[0]
        w = acq.member_weights
        if w is None:
            w = np.ones(m, np.float32)  # uniform start: exactly mc
        w = np.asarray(w, np.float32)
        if w.shape != (m,):
            raise ValueError(
                f"member_weights shape {w.shape} does not match the "
                f"{m}-member probs axis")
        return staged, torch.from_numpy(w).to(acq.torch_device)

    def extract_queries(self, acq, res) -> list:
        return acq._ids(res)
