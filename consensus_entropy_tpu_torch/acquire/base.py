"""The acquisition-strategy interface and registry.

Counterpart of ``consensus_entropy_tpu/acquire/base.py``.  A strategy is a
stateless singleton: per-user state (masks, the staged probs buffer,
reliability weights) lives on the ``Acquirer`` it is handed.
``scoring_inputs`` stages one scoring call (a key of
``ops.scoring.make_scoring_fns`` and its positional inputs),
``fused_inputs`` the fused variant over the acquirer's device masks,
``probs_plan`` the CNN probs producer as a device plan the fleet stacks,
and ``extract_queries`` maps the result back to song ids.
"""

from __future__ import annotations

import torch

from consensus_entropy_tpu_torch.parallel.mesh import ShardedRows


class AcquisitionStrategy:
    """One acquisition mode behind the ``Acquirer`` seam.

    Class flags, as in the JAX package:

    - ``needs_probs``: the loop computes a committee probs table
      ``(M, n_live, C)`` before scoring (mc/mix/wmc/qbdc);
    - ``probs_source``: which producer fills it, ``"committee"`` (the
      stored members) or ``"qbdc"`` (one CNN under K dropout masks);
    - ``uses_weights``: scoring reads the acquirer's ``member_weights``;
    - ``uses_hc_table`` / ``uses_hc_entropy``: the acquirer puts the
      human-consensus table (and its row entropies) on the device once and
      keeps the hc mask.
    """

    name: str = ""
    needs_probs: bool = False
    probs_source: str = "committee"
    uses_weights: bool = False
    uses_hc_table: bool = False
    uses_hc_entropy: bool = False

    def scoring_inputs(self, acq, member_probs=None, *, rand_key=None):
        """Stage one scoring call: ``(fn_key, inputs)``.  Mask updates wait
        for ``finish_select``."""
        raise NotImplementedError

    def fused_inputs(self, acq, member_probs=None, *, rand_key=None):
        """Stage the fused call (score -> top-k -> in-place mask update)
        over ``acq.device_masks()``, or ``None`` for a mode without one:
        the acquirer then takes the two-call path."""
        return None

    def probs_plan(self, committee, store, song_ids, key, *, pad_to,
                   config):
        """Stage this mode's CNN probs production as a batchable device
        plan (``models.committee``: ``CNNScorePlan`` / ``QBDCScorePlan``)
        that the fleet stacks across a cohort, or ``None`` for the inline
        per-user path.  Routed by ``probs_source``."""
        if not self.needs_probs:
            return None
        if self.probs_source == "qbdc":
            return committee.qbdc_score_plan(store, song_ids, key,
                                             k=config.qbdc_k, pad_to=pad_to)
        return committee.cnn_score_plan(store, song_ids, key, pad_to=pad_to)

    def extract_queries(self, acq, res) -> list:
        """Map a scoring result to song ids and apply any mode-specific mask
        change (hc row removal, mix dedup); the common pool shrink happens
        in ``Acquirer.finish_select``."""
        raise NotImplementedError


_REGISTRY: dict[str, AcquisitionStrategy] = {}


def register(strategy: AcquisitionStrategy) -> AcquisitionStrategy:
    """Register ``strategy`` under its name.  A name already held by a
    strategy of another type fails loud; the same type again is a no-op."""
    name = strategy.name
    if not name:
        raise ValueError(f"{type(strategy).__name__} has no name")
    prev = _REGISTRY.get(name)
    if prev is not None and type(prev) is not type(strategy):
        raise ValueError(
            f"acquisition mode {name!r} is already registered to "
            f"{type(prev).__name__}")
    _REGISTRY[name] = strategy
    return strategy


def get(mode: str) -> AcquisitionStrategy:
    try:
        return _REGISTRY[mode]
    except KeyError:
        raise ValueError(
            f"unknown mode {mode!r} (registered: "
            f"{', '.join(available_modes())})") from None


def available_modes() -> tuple[str, ...]:
    """Registered mode names in registration order."""
    return tuple(_REGISTRY)


def sanitize_member_rows(p: torch.Tensor) -> torch.Tensor:
    """Replace degenerate member rows before the consensus.

    A row (one member's distribution for one song) is invalid when it holds
    a non-finite value or sums to zero.  It becomes the mean of the song's
    valid rows, so the member mean renormalises over the survivors; a song
    with no valid row becomes uniform.  Selected with ``torch.where``, so
    with every row valid the output is the input, bit for bit.  Row-local,
    so a pool-sharded table is sanitized shard by shard.
    """
    if isinstance(p, ShardedRows):
        return p.map(sanitize_member_rows)
    valid = (torch.isfinite(p).all(dim=-1) & (p.sum(dim=-1) > 0))[..., None]
    safe = torch.where(valid, p, 0.0)
    cnt = valid.sum(dim=0)
    fallback = torch.where(cnt > 0, safe.sum(dim=0) / cnt.clamp(min=1),
                           1.0 / p.shape[-1])
    return torch.where(valid, p, fallback[None])
