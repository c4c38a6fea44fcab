"""The paper's four acquisition modes as registered strategies.

Counterpart of ``consensus_entropy_tpu/acquire/builtin.py``
(``amg_test.py:425-489``).  The unfused inputs upload the acquirer's host
masks as they stand, so callers score before finishing.
"""

from __future__ import annotations

import numpy as np

from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.acquire.base import (
    AcquisitionStrategy,
    sanitize_member_rows,
)
from consensus_entropy_tpu_torch.ops import scoring


class MachineConsensus(AcquisitionStrategy):
    """mc: committee probs -> mean -> entropy -> top-q
    (``amg_test.py:425-447``)."""

    name = "mc"
    needs_probs = True

    def scoring_inputs(self, acq, member_probs=None, *, rand_key=None):
        return "mc", (sanitize_member_rows(acq._staged_probs(member_probs)),
                      acq._feed(acq.pool_mask))

    def fused_inputs(self, acq, member_probs=None, *, rand_key=None):
        return "mc_fused", (
            sanitize_member_rows(acq._staged_probs(member_probs)),
            acq.device_masks().pool_mask)

    def extract_queries(self, acq, res) -> list:
        return acq._ids(res)


class HumanConsensus(AcquisitionStrategy):
    """hc: entropy of annotator-frequency rows, queried rows removed
    (``amg_test.py:449-455``), over row entropies computed once."""

    name = "hc"
    uses_hc_table = True
    uses_hc_entropy = True

    def scoring_inputs(self, acq, member_probs=None, *, rand_key=None):
        return "hc_pre", (acq.device.hc_ent, acq._feed(acq.hc_mask))

    def fused_inputs(self, acq, member_probs=None, *, rand_key=None):
        d = acq.device_masks()
        return "hc_pre_fused", (d.hc_ent, d.hc_mask, d.pool_mask)

    def extract_queries(self, acq, res) -> list:
        q_songs = acq._ids(res)
        acq._remove_hc(q_songs)  # amg_test.py:455
        return q_songs


class MixedConsensus(AcquisitionStrategy):
    """mix: entropy over stacked [mc consensus; hc rows], ranked jointly
    (``amg_test.py:457-484``)."""

    name = "mix"
    needs_probs = True
    uses_hc_table = True

    def scoring_inputs(self, acq, member_probs=None, *, rand_key=None):
        return "mix", (sanitize_member_rows(acq._staged_probs(member_probs)),
                       acq._feed(acq.pool_mask), acq.device.hc,
                       acq._feed(acq.hc_mask))

    def fused_inputs(self, acq, member_probs=None, *, rand_key=None):
        d = acq.device_masks()
        return "mix_fused", (
            sanitize_member_rows(acq._staged_probs(member_probs)),
            d.pool_mask, d.hc, d.hc_mask)

    def extract_queries(self, acq, res) -> list:
        _, slots = scoring.split_mix_index(res.indices, acq.n_pad)
        valid = scoring.selection_scalars(res.values) > -np.inf
        raw = [acq.songs[int(s)]  # cetpu: noqa[implicit-host-sync] s is a numpy scalar of selection_scalars' pull
               for s, ok in zip(scoring.selection_scalars(slots), valid)
               if ok]
        # a song can surface from both blocks; the reference's isin-based
        # batch build dedups it (amg_test.py:491), keeping the order
        q_songs = list(dict.fromkeys(raw))
        acq._remove_hc(q_songs)  # amg_test.py:484
        return q_songs


class RandomBaseline(AcquisitionStrategy):
    """rand: uniform shuffle via top-k over threefry uniform scores
    (``amg_test.py:486-489``), drawn on the mask's device whatever device
    the key is on.  Without an explicit key, the acquirer's seeded stream
    is split."""

    name = "rand"

    @staticmethod
    def _key(acq, rand_key):
        if rand_key is None:
            acq._rand_key, rand_key = prng.split(acq._rand_key)
        return rand_key

    def scoring_inputs(self, acq, member_probs=None, *, rand_key=None):
        return "rand", (self._key(acq, rand_key), acq._feed(acq.pool_mask))

    def fused_inputs(self, acq, member_probs=None, *, rand_key=None):
        return "rand_fused", (self._key(acq, rand_key),
                              acq.device_masks().pool_mask)

    def extract_queries(self, acq, res) -> list:
        return acq._ids(res)
