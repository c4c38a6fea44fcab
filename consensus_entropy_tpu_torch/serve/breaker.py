"""Per-bucket circuit breaker for stacked scoring dispatches.

Counterpart of ``consensus_entropy_tpu/serve/breaker.py`` (``:42-146``).
A stacked dispatch couples its sessions' fates: a width whose stacked call
keeps failing (an out-of-memory at that width, a degenerate member payload
only that gang produces) would fail every batch routed to it.  The
breaker isolates the failure per bucket width:

- **closed**: stacked dispatch allowed; ``threshold`` consecutive
  failures of the stacked call open it;
- **open**: the width runs per-user (width-1) dispatch, the sequential
  path itself, for ``cooldown_s``;
- **half-open**: after the cooldown ONE stacked probe goes through;
  success closes the breaker, failure re-opens it;
- **gave up**: with a ``probe_budget``, a width whose probes keep failing
  stays per-user for the rest of the run.  A restart gets a fresh budget:
  the state is in memory on purpose (an availability tactic, not durable
  truth).

The signals come from ``FleetScheduler._dispatch_scores``, the only
stacked-dispatch site, which also serves the per-user fallback.
"""

from __future__ import annotations

import dataclasses
import time

#: breaker dispositions, as reported in telemetry events
CLOSED, OPEN, HALF_OPEN, GAVE_UP = "closed", "open", "half_open", "gave_up"


@dataclasses.dataclass
class _BucketState:
    state: str = CLOSED
    consecutive_failures: int = 0
    opened_at: float = 0.0
    probing: bool = False
    failed_probes: int = 0


class DispatchBreaker:
    """Per-width breaker state machine (see module docstring).

    ``threshold``: consecutive stacked-dispatch failures that open a
    width.  ``cooldown_s``: how long an open width stays degraded before
    a half-open probe.  ``probe_budget``: failed half-open probes allowed
    before the width is given up for the run (0 = probe forever).
    ``clock``: injectable monotonic source (tests).  ``trips`` counts
    closed→open transitions for telemetry."""

    def __init__(self, threshold: int = 2, cooldown_s: float = 30.0, *,
                 probe_budget: int = 0, clock=time.monotonic):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0, got {cooldown_s}")
        if probe_budget < 0:
            raise ValueError(f"probe_budget must be >= 0, "
                             f"got {probe_budget}")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.probe_budget = probe_budget
        self._clock = clock
        self._buckets: dict[int, _BucketState] = {}
        self.trips = 0

    def _bucket(self, width: int) -> _BucketState:
        return self._buckets.setdefault(width, _BucketState())

    def state_of(self, width: int) -> str:
        return self._bucket(width).state

    def allow_stacked(self, width: int) -> bool:
        """May this width dispatch stacked right now?  An open bucket past
        its cooldown transitions to half-open and admits ONE probe; while
        the probe's verdict is pending, further batches stay degraded.  A
        given-up width never dispatches stacked again this run."""
        b = self._bucket(width)
        if b.state == CLOSED:
            return True
        if b.state == GAVE_UP:
            return False
        if b.state == OPEN \
                and self._clock() - b.opened_at >= self.cooldown_s:
            b.state = HALF_OPEN
            b.probing = False
        if b.state == HALF_OPEN and not b.probing:
            b.probing = True
            return True
        return False

    def record_success(self, width: int) -> str | None:
        """A stacked dispatch at ``width`` succeeded.  Returns ``"close"``
        when this was the half-open probe re-closing the breaker (the
        caller emits the recovery event), else ``None``."""
        b = self._bucket(width)
        was_probe = b.state == HALF_OPEN
        b.state = CLOSED
        b.consecutive_failures = 0
        b.probing = False
        b.failed_probes = 0
        return "close" if was_probe else None

    def record_failure(self, width: int) -> str | None:
        """A stacked dispatch at ``width`` failed.  Returns ``"open"`` on
        a closed→open or half-open→open transition, ``"giveup"`` when the
        failed probe spent the width's probe budget (the caller emits the
        matching telemetry event), else ``None``."""
        b = self._bucket(width)
        b.consecutive_failures += 1
        if b.state == HALF_OPEN:
            b.failed_probes += 1
            b.probing = False
            if self.probe_budget and b.failed_probes >= self.probe_budget:
                # the width has proven it cannot recover: stop paying one
                # failed stacked batch per cooldown and stay per-user
                b.state = GAVE_UP
                return "giveup"
            b.state = OPEN
            b.opened_at = self._clock()
            self.trips += 1
            return "open"
        if b.consecutive_failures >= self.threshold:
            # failures only arrive when allow_stacked admitted the batch,
            # so the prior state here is closed — a fresh trip
            b.state = OPEN
            b.opened_at = self._clock()
            b.probing = False
            self.trips += 1
            return "open"
        return None

    def summary(self) -> dict:
        """``{width: state}`` for every width that ever tripped or is
        currently degraded — quiet (always-closed) widths are omitted."""
        return {w: b.state for w, b in sorted(self._buckets.items())
                if b.state != CLOSED or b.consecutive_failures > 0}
