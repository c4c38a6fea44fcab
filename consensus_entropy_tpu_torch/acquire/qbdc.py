"""qbdc — query-by-dropout-committee (arxiv 1511.06412).

Counterpart of ``consensus_entropy_tpu/acquire/qbdc.py``: one personalised
CNN forwarded under K seeded dropout masks replaces the stored committee,
and scoring is mc's reduction over those K forwards.  The producer
(``probs_source == "qbdc"``) is ``Committee.qbdc_pool_probs``, which the
session calls.
"""

from __future__ import annotations

from consensus_entropy_tpu_torch.acquire.base import (
    AcquisitionStrategy,
    sanitize_member_rows,
)


class DropoutCommittee(AcquisitionStrategy):
    name = "qbdc"
    needs_probs = True
    probs_source = "qbdc"

    def scoring_inputs(self, acq, member_probs=None, *, rand_key=None):
        return "qbdc", (
            sanitize_member_rows(acq._staged_probs(member_probs)),
            acq._feed(acq.pool_mask))

    def fused_inputs(self, acq, member_probs=None, *, rand_key=None):
        return "qbdc_fused", (
            sanitize_member_rows(acq._staged_probs(member_probs)),
            acq.device_masks().pool_mask)

    def extract_queries(self, acq, res) -> list:
        return acq._ids(res)
