"""Remediation policy kernels: alert and journal state to fabric action.

Counterpart of ``consensus_entropy_tpu/serve/remedy.py``.  A sustained
``placement_skew`` alert on an overloaded live host triggers a
drain-for-rebalance (its queued users move over the drop-ack path, its
in-flight users over the checkpoint fence, and the host keeps serving);
a fence not acked within the operator's deadline falls back to
evict+resume; the gray ladder's rungs and the depth dial are decided
here too.

Everything here is a pure decision kernel: no clock reads, no journal
writes, no I/O.  The coordinator's pumps supply journal-replayed loads and
injected-clock times, journal each decision (``remedy`` records behind
the ``fabric.remedy`` fault point) before acting, and act through the
ack-gated verbs, so a coordinator killed mid-remediation re-derives the
same action sequence and never moves a user twice.

:func:`shed_count` sheds exactly down to ``floor + max_skew``, the highest
load that does not alert, so one remediation clears its own trigger and
cannot flap.
"""

from __future__ import annotations

#: how long a skew alert must hold CONTINUOUSLY before the pump acts —
#: the hysteresis guard against remediating a transient imbalance the
#: normal placement flow is about to absorb anyway
DEFAULT_HOLD_S = 1.0
#: minimum seconds between journaled remediations — the rate limit that
#: keeps a pathological workload from turning the remedy pump into a
#: migration storm
DEFAULT_COOLDOWN_S = 5.0


def shed_count(load: int, floor: int, *, max_skew: int) -> int:
    """How many users an overloaded host sheds to clear a skew alert.

    Pure decision kernel: the host
    sheds down to exactly ``floor + max_skew`` — the highest load that
    does NOT trip :func:`~consensus_entropy_tpu_torch.obs.alerts.skew_alerts`
    (which fires on ``load - floor > max_skew``).  Flap-free by
    construction:

    - shedding onto other hosts can only RAISE the fleet's floor, never
      lower it, so the post-shed host sits at or below the alert line;
    - a host at or below the line sheds nothing (``max(0, ...)``), so a
      cleared condition never re-triggers from the same imbalance.
    """
    return max(0, int(load) - int(floor) - int(max_skew))


def remedy_due(held_since: float | None, now: float, *,
               hold_s: float) -> bool:
    """True once an alert condition has held CONTINUOUSLY for
    ``hold_s`` seconds (``held_since`` is the injected-clock time the
    pump first saw it; ``None`` means it is not currently active).  The
    hysteresis guard: a transient skew that clears within the hold never
    triggers a remediation — mirroring the scale-down low-water timer."""
    return held_since is not None and now - held_since >= hold_s


def cooldown_ok(last_t: float | None, now: float, *,
                cooldown_s: float) -> bool:
    """True when enough time has passed since the LAST journaled
    remediation (``None`` = never remediated) for another to fire — the
    pump's rate limit."""
    return last_t is None or now - last_t >= cooldown_s


def fence_expired(fenced_t: float | None, now: float, *,
                  deadline_s: float) -> bool:
    """True when a checkpoint fence sent at ``fenced_t`` has gone
    unacked past the operator's ``--fence-deadline-s`` — the degradation
    trigger: the coordinator stops waiting for the iteration boundary
    and falls back to evict+resume (the session releases mid-iteration;
    its workspace stays at the last committed checkpoint, exactly the
    single-host eviction semantics).  ``deadline_s <= 0`` disables the
    deadline (a fence then waits for its boundary forever);
    ``fenced_t is None`` means no fence is pending."""
    return deadline_s > 0 and fenced_t is not None \
        and now - fenced_t >= deadline_s


#: the gray-failure escalation ladder, in rung order.  ``suspect`` is
#: the detector's edge (an active ``gray_suspect`` alert); ``probation``
#: stops routing NEW users to the host (journaled — replay-deterministic);
#: ``drain`` moves its existing users off over the drain-for-rebalance
#: machinery; the deadline-fenced EVICT beyond it is not a rung of its
#: own — it is the existing fence-deadline fallback firing on the
#: drain's fences.
GRAY_RUNGS = ("healthy", "suspect", "probation", "drain")

#: how long a gray_suspect alert must hold continuously before the host
#: goes on probation (longer than the skew hold: probation is a routing
#: change, and gray signals are noisier than replayed load counts)
DEFAULT_GRAY_HOLD_S = 2.0
#: how much LONGER the alert must keep holding (after probation) before
#: the ladder escalates to draining the host's existing users
DEFAULT_GRAY_DRAIN_S = 4.0
#: how long a probation host must stay CLEAN (no gray_suspect alert)
#: before probation lifts — the down-ladder hysteresis, so a host that
#: oscillates around the gate doesn't flap in and out of rotation
DEFAULT_GRAY_CLEAR_S = 4.0
#: how long a probation host's slo_headroom burn must hold before the
#: coordinator degrades it to cheap-stage committee scoring
DEFAULT_DEPTH_HOLD_S = 2.0


def gray_rung(held_since: float | None, now: float, *, hold_s: float,
              drain_s: float) -> str:
    """Map CONTINUOUS gray-suspect evidence age onto the ladder rung the
    host has earned (see :data:`GRAY_RUNGS`).  ``held_since`` is the
    injected-clock time the pump first saw the host's gray_suspect alert
    (``None`` = not currently suspect).  Each rung is gated on SUSTAINED
    evidence — the same hysteresis shape as :func:`remedy_due`, stacked:
    suspect immediately, probation after ``hold_s``, drain after
    ``hold_s + drain_s`` more of the same."""
    if held_since is None:
        return "healthy"
    held = now - held_since
    if held >= hold_s + drain_s:
        return "drain"
    if held >= hold_s:
        return "probation"
    return "suspect"


def probation_clear(clean_since: float | None, now: float, *,
                    clear_s: float) -> bool:
    """True once a probation host has been CLEAN (no active gray_suspect
    alert) continuously for ``clear_s`` — the lift gate.  ``clean_since``
    is the injected-clock time the pump last saw the host's alert clear
    (``None`` = still suspect, never lifts)."""
    return clean_since is not None and now - clean_since >= clear_s


def degrade_depth(on_probation: bool, burn_held_s: float | None, *,
                  hold_s: float) -> bool:
    """True when a probation host should drop to cheap-stage committee
    scoring: only ON probation (a healthy host under burn is a load
    problem — the remedy plane's job, not depth's) and only after its
    ``slo_headroom`` burn has held continuously for ``hold_s``
    (``burn_held_s`` = seconds the burn alert has held; ``None`` = not
    burning).  The restore edge is the complement: not on probation, or
    burn cleared."""
    return bool(on_probation) and burn_held_s is not None \
        and burn_held_s >= hold_s


def pick_shed(queued: list, in_flight: list, count: int, *,
              migrate_inflight: bool = True) -> tuple[list, list]:
    """Split an overloaded host's shed set into ``(drops, fences)``.

    Pure selection kernel: queued users shed FIRST (a drop is free — the
    user never started), latest-enqueued first (the ``plan_rebalance``
    contract: users most recently routed to the hot host are the ones a
    better-informed placement would have sent elsewhere); in-flight
    users fill the remainder via checkpoint fences, earliest-admitted
    first (the longest-running session has the most sunk work per move —
    shed it last... i.e. in-flight victims are taken from the END of the
    first-admit-ordered list).  ``migrate_inflight=False`` sheds queued
    users only (the drain-by-waiting arm)."""
    n = max(0, int(count))
    drops = list(reversed(queued))[:n]
    fences: list = []
    if migrate_inflight and len(drops) < n:
        fences = list(reversed(in_flight))[: n - len(drops)]
    return drops, fences
