"""The admission layer: a long-running driver for the fleet engine.

Counterpart of ``consensus_entropy_tpu/serve/server.py`` (``:95-1292``),
the fabric's seams included: ``fence`` and ``evict`` release an in-flight
user at its next checkpoint or step for a migration, ``apply_fleet_edges``
adopts the coordinator's bucket edges, ``set_depth`` is the gray ladder's
dial, and the ``status`` / ``alerts`` limbs take the introspection plane
(``obs.status.StatusWriter``, ``obs.alerts.AlertWatcher``).
``FleetServer`` holds a :class:`~consensus_entropy_
tpu_torch.fleet.scheduler.FleetScheduler` open (``open`` / ``admit`` /
``pump`` / ``close``) and feeds it continuously:

- **Continuous batching**: the moment a session finishes (or fails
  terminally) its slot is refilled from the waiting queue, so stacked
  dispatches do not drain at a cohort's tail.
- **Bucketed padding**: each user's pool pad is pinned at admission to a
  :class:`~consensus_entropy_tpu_torch.serve.buckets.BucketRouter` edge,
  and the engine dispatches one stacked call per bucket per mode through
  the per-width families (``FleetScheduler(scoring_by_width=True)``); CNN
  plan groups stack per bucket the same way.
- **Backpressure**: the waiting queue is bounded (:class:`AdmissionQueue`);
  ``submit`` raises :class:`QueueFull` at the bound, and ``serve(source)``
  stops drawing from its iterator until a slot frees.
- **Drain**: when the preemption guard trips, admission stops, in-flight
  sessions run to completion, queued users are left untouched and
  ``Preempted`` is raised (the CLI exits 75).
- **Crash safety**: every admission transition goes through the
  :class:`~consensus_entropy_tpu_torch.serve.journal.AdmissionJournal`,
  so a server killed and restarted from ``serve_journal.jsonl`` loses no
  user (finished skipped, in-flight re-admitted first, queued re-enqueued
  in order).
- **Watchdog**, **backoff re-admission** up to ``failure_budget``
  admissions and then the poison list, and the per-bucket **circuit
  breaker** (``serve.watchdog``, ``resilience.retry.backoff_delay``,
  ``serve.breaker``).
- **SLO-aware admission** (``serve.planner``): bucket edges derived from a
  journaled quantile sketch, priority classes with aging, adaptive holds
  inside per-class SLO headroom; ``slo_planner=False`` keeps fixed
  windows.

Each user's result is its sequential ``ALLoop`` run's: the server drives
the same session generators through the same engine, and padding, holds
and the watchdog change when work runs, never what it computes.  Sessions
run without the preemption guard (the server owns it), so a drain
finishes in-flight work; the constructor refuses a scheduler that would
hand the guard to its sessions.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np

from consensus_entropy_tpu_torch.fleet.scheduler import (
    FleetScheduler,
    FleetUser,
)
from consensus_entropy_tpu_torch.resilience import faults
from consensus_entropy_tpu_torch.resilience.retry import backoff_delay
from consensus_entropy_tpu_torch.serve.breaker import DispatchBreaker
from consensus_entropy_tpu_torch.serve.buckets import (
    BucketRouter,
    validate_bucket_widths,
)
from consensus_entropy_tpu_torch.serve.journal import PoisonList
from consensus_entropy_tpu_torch.serve.planner import (
    DEFAULT_CLASS,
    PRIORITY_CLASSES,
    AdmissionPlanner,
)
from consensus_entropy_tpu_torch.serve.watchdog import Watchdog


class QueueFull(RuntimeError):
    """The bounded waiting queue rejected an enqueue (backpressure)."""


class QueueClosed(RuntimeError):
    """The waiting queue was closed (drain): producers must stop
    retrying — the entry will never be accepted this run."""


@dataclasses.dataclass
class ServeConfig:
    """Admission policy knobs.

    ``target_live``: occupancy target — the server tops the engine up to
    this many concurrently-live sessions whenever slots free.
    ``max_queue``: waiting-room bound (backpressure past it).
    ``admit_window_s``: with free slots and an EMPTY queue while intake is
    still open, wait up to this long for arrivals before idling on — a
    gang of users admitted together phase-aligns into one bucket dispatch,
    where one-at-a-time trickle admission would stagger them (the
    admission-side sibling of the engine's ``batch_window_s``).
    ``bucket_widths``: explicit bucket edges, or ``None`` for powers of
    two (see :class:`BucketRouter`).

    Fault-domain knobs:
    ``watchdog_s``: wall-clock deadline per engine step (host block or
    device dispatch); 0 disables.  ``failure_budget``: total admissions
    per user (first + backoff re-admissions) before the user is poisoned;
    1 disables re-admission.  ``backoff_base_s``/``backoff_max_s``/
    ``backoff_seed``: the seeded-jitter exponential re-admission schedule
    (``resilience.retry.backoff_delay``).  ``breaker_threshold``:
    consecutive stacked-dispatch failures that open a bucket's circuit
    breaker (0 disables); ``breaker_cooldown_s``: how long an open bucket
    stays degraded to per-user dispatch before a half-open probe;
    ``breaker_probes``: failed half-open probes before the width is given
    up (stays per-user) for the rest of the run (0 probes forever).

    SLO-planner knobs (``serve.planner``; ``slo_planner=False`` keeps
    the fixed-window arm throughout):
    ``planner_epoch``: enqueue observations between bucket-edge
    re-derivations; ``planner_buckets``: quantile edges derived per
    epoch (the top edge is the observed max).  With explicit
    ``bucket_widths`` the planner never overrides them (operator edges
    win; classes + holds stay active).  ``slo_interactive_s`` /
    ``slo_batch_s``: per-class admission→finish latency targets — the
    headroom every adaptive hold is bounded by.  ``aging_s``: queue-wait
    past which a lower-priority user jumps strict-priority pop (the
    starvation guard; 0 = pure strict priority).  ``max_hold_s``: cap on
    any single adaptive ADMISSION hold, the cap on DISPATCH holds until
    host-step telemetry exists, and the off switch for both at 0.  Once
    the observed host-step duration EMA is known, dispatch holds are
    SIZED by it instead of capped here (telemetry-predicted holds —
    ``serve.planner.dispatch_hold``) and only SLO headroom bounds them.
    Explicit ``admit_window_s`` / ``batch_window_s`` remain honored as
    FLOORS — the planner can only hold longer, and only inside SLO
    headroom.
    """

    target_live: int = 4
    max_queue: int = 64
    admit_window_s: float = 0.0
    bucket_widths: tuple | None = None
    #: pool-axis mesh width: shard every stacked scoring dispatch (and
    #: the fused select→reveal→mask step) across this many local devices
    #: (``parallel.pool_mesh``).  1 = the unsharded single-device arm.
    #: Every bucket width must divide by it — the pool axis splits a
    #: bucket's padded width evenly across devices, so an explicit edge
    #: geometry that doesn't divide fails HERE, not as a shard mismatch
    #: at the first dispatch
    mesh_devices: int = 1
    watchdog_s: float = 0.0
    failure_budget: int = 3
    backoff_base_s: float = 0.25
    backoff_max_s: float = 8.0
    backoff_seed: int = 0
    breaker_threshold: int = 0
    breaker_cooldown_s: float = 30.0
    breaker_probes: int = 0
    slo_planner: bool = True
    planner_epoch: int = 8
    planner_buckets: int = 4
    slo_interactive_s: float = 60.0
    slo_batch_s: float = 600.0
    aging_s: float = 30.0
    max_hold_s: float = 1.0
    #: engine slots RESERVED for the ``batch`` class (clamped to
    #: ``target_live - 1``; 0 disables): aging orders the QUEUE, but an
    #: interactive surge could still monopolize every SLOT for
    #: ``aging_s`` — the reserve bounds the batch tail directly, because
    #: the last reserved slot only ever admits a batch waiter (ROADMAP
    #: planner follow-on (b))
    batch_reserve: int = 1

    def __post_init__(self):
        if self.target_live < 1:
            raise ValueError(f"target_live must be >= 1, "
                             f"got {self.target_live}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.bucket_widths is not None:
            # a typo'd geometry (unsorted, duplicated, non-positive, or
            # edges collapsing onto one PAD_MULTIPLE family) fails HERE,
            # not as silent misrouting at admission time
            self.bucket_widths = validate_bucket_widths(self.bucket_widths)
        if self.mesh_devices < 1:
            raise ValueError(f"mesh_devices must be >= 1, "
                             f"got {self.mesh_devices}")
        if self.mesh_devices > 1 and self.bucket_widths is not None:
            bad = [w for w in self.bucket_widths
                   if w % self.mesh_devices]
            if bad:
                raise ValueError(
                    f"bucket widths {bad} do not divide across a "
                    f"{self.mesh_devices}-device pool mesh — every "
                    f"explicit --bucket-widths edge must be a multiple "
                    f"of --mesh-devices so the pool axis shards evenly")
        if (self.mesh_devices > 1 and self.bucket_widths is None
                and self.mesh_devices & (self.mesh_devices - 1)):
            # implicit geometry (planner quantiles, power-of-two
            # fall-through) only ever emits PAD_MULTIPLE-rounded
            # power-of-two-friendly widths; a 3- or 6-device mesh can
            # never divide them and would fail at first dispatch instead
            raise ValueError(
                f"mesh_devices={self.mesh_devices} must be a power of "
                f"two under the implicit bucket geometry — pass explicit "
                f"--bucket-widths that divide it instead")
        if self.watchdog_s < 0:
            raise ValueError(f"watchdog_s must be >= 0, "
                             f"got {self.watchdog_s}")
        if self.failure_budget < 1:
            raise ValueError(f"failure_budget must be >= 1, "
                             f"got {self.failure_budget}")
        if self.breaker_threshold < 0:
            raise ValueError(f"breaker_threshold must be >= 0, "
                             f"got {self.breaker_threshold}")
        if self.breaker_probes < 0:
            raise ValueError(f"breaker_probes must be >= 0, "
                             f"got {self.breaker_probes}")
        if self.planner_epoch < 1:
            raise ValueError(f"planner_epoch must be >= 1, "
                             f"got {self.planner_epoch}")
        if self.planner_buckets < 1:
            raise ValueError(f"planner_buckets must be >= 1, "
                             f"got {self.planner_buckets}")
        if self.slo_interactive_s <= 0 or self.slo_batch_s <= 0:
            raise ValueError("per-class SLO targets must be > 0, got "
                             f"interactive={self.slo_interactive_s} "
                             f"batch={self.slo_batch_s}")
        if self.aging_s < 0:
            raise ValueError(f"aging_s must be >= 0, got {self.aging_s}")
        if self.max_hold_s < 0:
            raise ValueError(f"max_hold_s must be >= 0, "
                             f"got {self.max_hold_s}")
        if self.batch_reserve < 0:
            raise ValueError(f"batch_reserve must be >= 0, "
                             f"got {self.batch_reserve}")


class AdmissionQueue:
    """Bounded, PRIORITY-CLASS-aware waiting room; thread-safe (producers
    may ``put`` from other threads while the serve loop pops).  Entries
    carry their enqueue timestamp so admission latency is measurable.

    ``classes`` (highest priority first, default
    :data:`~consensus_entropy_tpu_torch.serve.planner.PRIORITY_CLASSES`): each
    entry lands in the deque of its ``priority`` attribute (unknown or
    missing → the lowest class), FIFO within a class.  :meth:`pop` is
    STRICT priority — ``interactive`` ahead of ``batch`` — with an AGING
    guard: a lower-class head that has waited past ``aging_s`` jumps the
    order (oldest aged head first), so strict priority cannot starve the
    batch tier behind a steady interactive stream.  ``aging_s=0``
    disables aging (pure strict priority).

    ``reserve`` (``{class: min_slots}``): per-class ENGINE-SLOT shares —
    when the caller passes its live class composition and free-slot
    count to :meth:`pop`, a class with waiters whose reserved share is
    unmet claims the last free slots ahead of strict priority, so a
    higher-priority surge can occupy at most
    ``target_live - sum(reserves)`` slots while reserved classes wait
    (the aging guard bounds queue ORDER; the reserve bounds SLOT
    occupancy — starvation bound: a batch waiter admits within one slot
    turnover instead of ``aging_s``).

    ``bound_reserve`` (``{class: queue_slots}``): per-class shares of
    the QUEUE BOUND itself — a class's :meth:`put` fails once the queue
    holds ``maxsize`` minus the other classes' UNMET bound reservations.
    Without it, a never-stopping higher-priority producer stream fills
    all ``maxsize`` slots and lower-class producers get ``QueueFull``
    forever, so the aging guard never even SEES a lower-class head to
    promote — starvation moved from the pop order (fixed by aging) to
    the bound.  ``None`` (the default) keeps the class-blind bound.

    ``clock`` injects the timestamp source the aging guard and
    :meth:`head_waits` measure with (default ``time.perf_counter``) —
    compressed-time soak tests age entries without real waiting."""

    def __init__(self, maxsize: int, *, classes=PRIORITY_CLASSES,
                 aging_s: float = 0.0, reserve: dict | None = None,
                 bound_reserve: dict | None = None,
                 clock=time.perf_counter):
        self.maxsize = maxsize
        self.classes = tuple(classes)
        if not self.classes:
            raise ValueError("classes must be non-empty")
        self.aging_s = aging_s
        self.reserve = {cls: int(n) for cls, n in (reserve or {}).items()
                        if cls in self.classes and int(n) > 0}
        self.bound_reserve = {
            cls: int(n) for cls, n in (bound_reserve or {}).items()
            if cls in self.classes and int(n) > 0}
        if sum(self.bound_reserve.values()) >= maxsize:
            raise ValueError(
                f"bound_reserve {self.bound_reserve} must leave at "
                f"least one unreserved queue slot of {maxsize}")
        self._clock = clock
        self._q: dict[str, collections.deque] = {
            cls: collections.deque() for cls in self.classes}
        self._cond = threading.Condition()
        self._closed = False

    def _class_of(self, entry) -> str:
        cls = getattr(entry, "priority", None)
        return cls if cls in self._q else self.classes[-1]

    def _total(self) -> int:
        return sum(len(dq) for dq in self._q.values())

    def close(self) -> None:
        """Drain sentinel: no further ``put`` succeeds (``QueueClosed``),
        and every thread blocked in :meth:`wait_nonempty` /
        :meth:`wait_at_least` wakes PROMPTLY instead of spinning out its
        timeout — a producer stuck in a put-retry loop sees the closed
        queue on its next attempt and stops.  Entries already queued stay
        readable (a drain leaves them for the rerun)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def _bound_for(self, cls: str) -> int:
        """The queue-slot count ``cls`` may fill: ``maxsize`` minus the
        OTHER classes' unmet bound reservations (a reservation already
        covered by queued entries restricts nobody)."""
        held = sum(max(0, n - len(self._q[c]))
                   for c, n in self.bound_reserve.items() if c != cls)
        return self.maxsize - held

    def put(self, entry: FleetUser) -> int:
        """Enqueue; returns the depth AFTER.  Raises :class:`QueueFull`
        at the entry class's share of the bound (see ``bound_reserve``)
        — the caller (a producer) must back off — and
        :class:`QueueClosed` once the queue closed (stop retrying)."""
        with self._cond:
            if self._closed:
                raise QueueClosed("admission queue is closed (drain); "
                                  "stop submitting")
            cls = self._class_of(entry)
            if self._total() >= self._bound_for(cls):
                raise QueueFull(
                    f"admission queue is at its bound ({self.maxsize}) "
                    f"for class {cls!r}; retry after sessions drain")
            self._q[cls].append((entry, self._clock()))
            self._cond.notify_all()
            return self._total()

    def try_put(self, entry: FleetUser) -> int | None:
        """:meth:`put` that returns ``None`` instead of raising at the
        bound — the check and the append are one critical section, so a
        concurrent producer filling the last slot cannot turn the serve
        loop's own refill into an exception."""
        try:
            return self.put(entry)
        except QueueFull:
            return None

    def pop(self, *, live: dict | None = None, free: int | None = None):
        """``(entry, enqueue_t)`` or ``None`` when empty: the head of the
        highest-priority non-empty class — unless a lower class's head
        has AGED past ``aging_s``, in which case the oldest aged head
        pops first (the starvation guard).

        ``live`` (``{class: currently-admitted count}``) and ``free``
        (slots this admission round may still fill) activate the
        per-class RESERVE: when the free slots only just cover the
        waiting reserved classes' unmet shares, the pop is restricted to
        those classes — the last reserved slot can never go to a
        non-reserved surge.  Omitting either keeps the pre-reserve
        behavior (unit tests, non-slot callers)."""
        with self._cond:
            if self.aging_s > 0:
                now = self._clock()
                aged = [(self._q[cls][0][1], cls)
                        for cls in self.classes[1:]
                        if self._q[cls]
                        and now - self._q[cls][0][1] >= self.aging_s]
                if aged:
                    return self._q[min(aged)[1]].popleft()
            allowed = self.classes
            if self.reserve and live is not None and free is not None:
                deficits = {cls: self.reserve[cls] - live.get(cls, 0)
                            for cls in self.classes
                            if self._q[cls]
                            and live.get(cls, 0) < self.reserve.get(cls, 0)}
                if deficits and free <= sum(deficits.values()):
                    allowed = tuple(deficits)
            for cls in allowed:
                if self._q[cls]:
                    return self._q[cls].popleft()
            return None

    def remove(self, user_id) -> FleetUser | None:
        """Withdraw a still-queued entry by user id: returns the entry,
        or ``None`` when no queued entry matches (it was already
        admitted, or never queued)."""
        uid = str(user_id)
        with self._cond:
            for dq in self._q.values():
                for item in dq:
                    if str(item[0].user_id) == uid:
                        dq.remove(item)
                        return item[0]
        return None

    def depths(self) -> dict:
        """``{class: queued count}`` over every class (empty classes
        included)."""
        with self._cond:
            return {cls: len(dq) for cls, dq in self._q.items()}

    def head_waits(self) -> dict:
        """``{class: seconds its head entry has waited}`` for non-empty
        classes — the SLO-headroom input of the planner's admission
        hold."""
        with self._cond:
            now = self._clock()
            return {cls: now - dq[0][1]
                    for cls, dq in self._q.items() if dq}

    def wait_nonempty(self, timeout: float) -> bool:
        """True when the queue is non-empty at return; a :meth:`close`
        wakes the wait immediately (returning the actual emptiness) so
        drains never sit out the full timeout."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._closed or self._total() > 0,
                timeout=timeout)
            return self._total() > 0

    def wait_at_least(self, n: int, timeout: float) -> bool:
        """Block until the queue holds ``n`` entries or ``timeout``
        elapses — the admission-window primitive: arrivals landing within
        the window gang into one admission (and thus phase-align into one
        bucket dispatch) instead of trickling in one at a time.  A
        :meth:`close` wakes the wait immediately."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._closed or self._total() >= n,
                timeout=timeout)
            return self._total() >= n

    def __len__(self) -> int:
        with self._cond:
            return self._total()


class FleetServer:
    """Drive one fleet engine as a continuously-admitted service.

    ``scheduler``: a :class:`FleetScheduler` built for serving —
    ``scoring_by_width=True``, ``preemption=None`` (the server owns the
    guard; a scheduler that would hand it to sessions is rejected, see
    module docstring).  ``preemption``: optional guard object with a
    boolean ``requested`` (``resilience.preemption.PreemptionGuard``).

    After :meth:`serve` returns (or raises ``Preempted`` post-drain),
    ``self.results`` holds the per-user records in admission order —
    the same schema as ``FleetScheduler.run``.
    """

    def __init__(self, scheduler: FleetScheduler, config: ServeConfig, *,
                 preemption=None, journal=None, poison=None,
                 status=None, alerts=None):
        if scheduler.preemption is not None:
            raise ValueError(
                "serve mode owns preemption: build the FleetScheduler with "
                "preemption=None and pass the guard to FleetServer — "
                "sessions holding the guard would abort mid-drain instead "
                "of finishing")
        self.scheduler = scheduler
        self.config = config
        if config.mesh_devices > 1:
            # install the pool mesh before the engine opens: the
            # scheduler picks its families per width at dispatch, so a
            # mesh set here routes every dispatch through the sharded
            # per-width families from the first admission
            from consensus_entropy_tpu_torch.parallel.pool_mesh import (
                make_pool_mesh_for)
            if scheduler.mesh is None:
                scheduler.mesh = make_pool_mesh_for(config.mesh_devices,
                                                    str(scheduler.device))
            elif scheduler.mesh.size != config.mesh_devices:
                raise ValueError(
                    f"scheduler carries a {scheduler.mesh.size}-device "
                    f"pool mesh but ServeConfig.mesh_devices="
                    f"{config.mesh_devices} — build one or the other, "
                    f"not a disagreeing pair")
        self.preemption = preemption
        self.router = BucketRouter(config.bucket_widths)
        # the batch-class slot share (clamped so interactive always keeps
        # at least one slot; a 1-slot engine cannot reserve anything)
        reserve = min(config.batch_reserve, config.target_live - 1)
        # the batch share of the queue BOUND mirrors its slot share
        # (clamped to leave an unreserved slot): a never-stopping
        # interactive producer stream cannot fill the whole waiting room
        # and starve batch producers at put() — without it the aging
        # guard never sees a batch head to promote
        bound = min(reserve, config.max_queue - 1)
        self.queue = AdmissionQueue(
            config.max_queue, aging_s=config.aging_s,
            reserve={"batch": reserve} if reserve > 0 else None,
            bound_reserve={"batch": bound} if bound > 0 else None)
        #: currently-admitted users' priority classes (uid → cls): the
        #: live composition the queue's per-class reserve pops against
        self._live_cls: dict[str, str] = {}
        self.report = scheduler.report
        self.results: list[dict] = []
        self._admitted: list[FleetUser] = []
        self._admitted_ids: set[int] = set()
        #: in-flight entry ids, ADMISSION-ordered (an insertion-ordered
        #: dict, not a set: ``_collect`` walks it to journal ``finish``
        #: records and fire ``on_result`` — set order would journal
        #: completions in id()-hash order, different every process)
        self._pending: dict[int, None] = {}
        #: one pulled-but-unqueued entry held when a concurrent submit()
        #: filled the queue's last slot between our pull and our put
        self._spill: FleetUser | None = None
        self._draining = False
        self._intake_open = True
        #: optional serve.journal.AdmissionJournal — the crash-safety WAL;
        #: its replayed state seeds skip/ordering/attempt decisions
        self.journal = journal
        #: serve.journal.PoisonList (in-memory when the caller passes
        #: none): users past their failure budget, skipped on submit
        self.poison = poison if poison is not None else PoisonList()
        #: per-user admission attempts (the failure-budget counter),
        #: seeded from the journal so the budget survives restarts
        self._attempts: dict[str, int] = (
            dict(journal.state.admits) if journal is not None else {})
        #: ``(due_monotonic, entry)`` backoff re-admissions not yet due
        self._requeue: list = []
        #: fence requests from the intake thread, applied (and their
        #: deferred acks journaled) on the serve-loop thread
        self._fence_req: list = []
        #: evict requests (the fence deadline's fallback): force-released
        #: at the next ready pop and acked as ``drop`` records
        self._evict_req: list = []
        #: uids whose deferred release acks as a ``drop`` (evicted), not
        #: a ``fence``; insertion-ordered for deterministic acks
        self._evicting: dict[str, None] = {}
        self._fence_lock = threading.Lock()
        #: the coordinator epoch this worker's feed latched
        #: (``serve.hosts.EpochGate``), echoed on every fence/drop ack so a
        #: coordinator discards acks addressed to a predecessor; ``None``
        #: outside a fabric
        self.epoch: int | None = None
        #: serve-local control-lane bookkeeping (``ctl.*`` spans): the last
        #: observed journal compaction count and breaker width states
        self._ctl_compactions = 0
        self._ctl_breaker: dict = {}
        #: the introspection plane: ``status`` a status writer the serve
        #: loop refreshes (``obs.status.StatusWriter`` or None),
        #: ``alerts`` an ``obs.alerts.AlertWatcher`` evaluated on the
        #: same cadence.  Observation only: neither feeds a journaled
        #: decision
        self.status = status
        self.alerts = alerts
        self._backoff_rng = np.random.default_rng(config.backoff_seed)
        # the fault-domain engine hooks: install from config unless the
        # caller wired its own instances into the scheduler already
        if config.watchdog_s > 0 and scheduler.watchdog is None:
            scheduler.watchdog = Watchdog(config.watchdog_s)
        if config.breaker_threshold > 0 and scheduler.breaker is None:
            scheduler.breaker = DispatchBreaker(
                config.breaker_threshold, config.breaker_cooldown_s,
                probe_budget=config.breaker_probes)
        if scheduler.on_terminal is not None:
            raise ValueError(
                "FleetServer owns the scheduler's on_terminal hook "
                "(backoff re-admission); build the scheduler with "
                "on_terminal=None")
        scheduler.on_terminal = self._on_terminal
        #: the SLO admission planner (serve.planner): adaptive bucket
        #: edges (journal-replayable), per-class SLO headroom, and the
        #: adaptive admission/dispatch holds.  None under
        #: ``--no-slo-planner`` — the fixed-window arm.  Construction
        #: RESTORES from the journal, so a restarted server routes with
        #: the killed run's exact edges before its first enqueue.
        self.planner = None
        if config.slo_planner:
            self.planner = AdmissionPlanner(
                config, router=self.router, journal=journal,
                report=self.report)
            if scheduler.hold is None:
                # the dispatch-hold policy: the engine holds partially
                # formed stacked dispatches (reductions AND CNN plan
                # cohorts) while host steps are in flight, inside SLO
                # headroom; an explicit batch_window_s stays a floor
                scheduler.hold = self.planner
            self.report.planner = self.planner

    # -- producer surface --------------------------------------------------

    def submit(self, entry: FleetUser) -> int:
        """Thread-safe enqueue for external producers; returns queue depth.
        Raises :class:`QueueFull` at the bound and ``RuntimeError``
        (:class:`QueueClosed` on a drained queue) once the server is
        draining or its intake closed.  A user the journal shows finished,
        or the poison list shows past its failure budget, is skipped (the
        skip is reported, the depth returned unchanged)."""
        if self._draining or not self._intake_open:
            raise RuntimeError("server is draining; not accepting users")
        if self._skip(entry):
            return len(self.queue)
        self._resolve_class(entry)
        depth = self.queue.put(entry)
        self._note_enqueued(entry, depth)
        return depth

    def _resolve_class(self, entry: FleetUser) -> str:
        """The entry's priority class: the journal's record wins (a
        re-submitted or restart-recovered user keeps the class its first
        enqueue recorded), then the entry's own ``priority``, then the
        default.  The resolved class is written back onto the entry so
        the queue's pop order and every downstream record agree."""
        cls = None
        if self.journal is not None:
            cls = self.journal.class_of(entry.user_id)
        if cls is None:
            cls = getattr(entry, "priority", None) or DEFAULT_CLASS
        if getattr(entry, "priority", None) != cls:
            entry.priority = cls
        return cls

    def _note_enqueued(self, entry: FleetUser, depth: int) -> None:
        """The shared post-put bookkeeping for every enqueue path
        (submit / pull-refill / backoff requeue): journal the transition
        (class + pool size — the planner's replayable observation
        stream), grade the telemetry, open the user's root span, and
        feed the planner's sketch + arrival-rate estimate."""
        cls = getattr(entry, "priority", None) or DEFAULT_CLASS
        pool = getattr(getattr(entry.data, "pool", None), "n_songs", None)
        if pool is not None:
            pool = int(pool)  # one coercion: the journal field and the
            # sketch observation must see the SAME value or replay
            # diverges from the live run
        fields = {"cls": cls}
        if pool is not None:
            fields["pool"] = pool
        if self.planner is not None:
            # the journal append and the sketch observation commit as
            # ONE critical section (the planner's lock), so a planner
            # epoch record always covers every enqueue journaled before
            # it — concurrent producers cannot race the epoch boundary
            # into a sketch that replay would reconstruct differently
            self.planner.observe_enqueue(
                # the wall read below sizes HOLDS only (when work
                # batches), never journaled results
                pool, t=time.monotonic(),
                journal_entry=lambda: self._journal(
                    "enqueue", entry.user_id, **fields))
        else:
            self._journal("enqueue", entry.user_id, **fields)
        self.report.enqueued(entry.user_id, depth, cls=cls)
        # the user's root span opens at FIRST enqueue (idempotent), so
        # admission waits nest inside it; the scheduler closes it when
        # the user resolves
        self.scheduler.tracer.open_user(str(entry.user_id))

    def _skip(self, entry: FleetUser) -> bool:
        """Journal-finished and poisoned users never re-enter the queue.
        Runs on producer threads too (``submit``), so it only touches the
        journal/poison list through their thread-safe surfaces."""
        uid = str(entry.user_id)
        if self.journal is not None and self.journal.is_finished(uid):
            self.report.event("skip_done", user=uid)
            return True
        if uid in self.poison:
            rec = self.poison.record(uid) or {}
            self.report.event("skip_poisoned", user=uid,
                              error=rec.get("error"),
                              attempts=rec.get("attempts"))
            return True
        return False

    def _journal(self, event: str, user, **fields) -> None:
        if self.journal is not None:
            self.journal.append(event, user, **fields)

    def close_intake(self) -> None:
        """No further ``submit``s: :meth:`serve` returns once the queue
        and the engine drain."""
        self._intake_open = False

    def withdraw(self, user_id) -> bool:
        """Remove a STILL-QUEUED user (a producer's disconnect).  Returns
        False when the user is not waiting — already admitted, finished,
        or never submitted here.  Thread-safe (producer threads call
        it)."""
        uid = str(user_id)
        entry = self.queue.remove(uid)
        if entry is None:
            return False
        if self.planner is not None:
            self.planner.note_resolved(uid)  # no admitted clock existed
        self.report.event("withdraw", user=uid)
        return True

    def fence(self, user_id) -> bool | None:
        """The fabric's in-flight migration seam (intake thread): release
        ``user_id`` so it can run elsewhere.  Still queued: withdrawn now,
        True.  In flight: the release is requested and the ack deferred,
        None; the serve loop releases the session at its next checkpoint
        boundary and journals ``ok`` with the generation then
        (:meth:`_apply_fences`).  Unknown or finished: False (refused; the
        user's own finish record resolves it)."""
        uid = str(user_id)
        if self.withdraw(uid):
            return True
        if uid in self._live_cls:
            with self._fence_lock:
                self._fence_req.append(uid)
            return None
        return False

    def evict(self, user_id) -> bool | None:
        """The fence deadline's fallback (intake thread): as
        :meth:`fence`, but an in-flight session is force-released at its
        next step boundary, dropping the current iteration's in-memory
        progress (the workspace stays at its last committed generation,
        which resume elsewhere replays), and acks as a ``drop``."""
        uid = str(user_id)
        if self.withdraw(uid):
            return True
        if uid in self._live_cls:
            with self._fence_lock:
                self._evict_req.append(uid)
            return None
        return False

    def ack_epoch(self) -> dict:
        """The latched coordinator epoch as ack fields (empty outside a
        fabric, so standalone journals keep their bytes)."""
        return {"ep": self.epoch} if isinstance(self.epoch, int) else {}

    def _apply_fences(self) -> None:
        """Serve-loop half of the fence: turn intake-thread requests into
        engine release marks, and journal the deferred acks of sessions
        that released.  A release is booked like a withdraw (slot freed,
        no result): the user's run continues on another host."""
        with self._fence_lock:
            reqs, self._fence_req = self._fence_req, []
            evicts, self._evict_req = self._evict_req, []
        for uid in reqs:
            if not self.scheduler.request_release(uid):
                # finished or evicted since the request: refused
                self._journal("fence", uid, ok=False, **self.ack_epoch())
        for uid in evicts:
            if self.scheduler.force_release(uid):
                self._evicting[uid] = None
            else:
                # finished, or its fence released it just before the
                # deadline's demotion arrived: that record resolves it
                self._journal("drop", uid, ok=False, **self.ack_epoch())
        for uid, gen in self.scheduler.take_released().items():
            self._live_cls.pop(uid, None)
            for e in self._admitted:
                if str(e.user_id) == uid:
                    self._pending.pop(id(e), None)
            if self.planner is not None:
                self.planner.note_resolved(uid)
            fields = {"ok": True, **self.ack_epoch()}
            if gen is not None:
                fields["gen"] = int(gen)
            # an evicted session acks as a drop (the coordinator's
            # drop-ack path completes the move), a fenced one as the
            # deferred fence ack; either way the workspace is durable at
            # ``gen`` and the run continues elsewhere from it
            kind = "drop" if uid in self._evicting else "fence"
            self._evicting.pop(uid, None)
            self._journal(kind, uid, **fields)
            tracer = self.scheduler.tracer
            if tracer.enabled and self.journal is not None:
                tracer.control_event(
                    "ctl.release", key=self.journal.state.seq,
                    flow_user=uid, kind=kind,
                    gen=None if gen is None else int(gen))

    def apply_fleet_edges(self, edges) -> None:
        """Adopt the coordinator's fleet-level bucket edges: future
        admissions route by them (pinned pads stay pinned) and the local
        planner stops deriving its own.  The fabric CLI never broadcasts
        when ``--bucket-widths`` is set."""
        new = tuple(int(e) for e in edges)
        if not new:
            return
        if self.planner is not None:
            self.planner.set_fleet_edges(new)
        else:
            self.router.update(new)
        self.report.event("fleet_edges", edges=list(new))

    def set_depth(self, depth: str) -> None:
        """The gray ladder's degradation dial: ``"cheap"`` caps every
        committee at its minimum size, ``"full"`` restores
        (``FleetScheduler.set_depth``; an unknown depth raises)."""
        self.scheduler.set_depth(depth)

    @property
    def draining(self) -> bool:
        return self._draining

    # -- the serve loop ----------------------------------------------------

    def serve(self, source=(), *, on_result=None,
              keep_open: bool = False) -> list[dict]:
        """Run until every admitted and queued user finished.

        ``source``: iterator of :class:`FleetUser` — pulled LAZILY as queue
        room frees (expensive per-user setup like workspace creation then
        happens just-in-time, and backpressure reaches the producer).
        ``on_result``: called with each user's record the moment it
        finishes (success or terminal failure) — a serving driver persists
        completed users immediately instead of at end-of-run.
        ``keep_open``: leave intake open after ``source`` exhausts
        (threaded producers; pair with :meth:`close_intake`).

        On preemption: finishes in-flight sessions, then raises
        ``Preempted`` (queued users untouched, ``self.results`` complete
        for every admitted user).
        """
        from consensus_entropy_tpu_torch.resilience.preemption import Preempted

        sched = self.scheduler
        cfg = self.config
        src = iter(source)
        src_live = True
        if self.journal is not None and self.journal.recovered:
            st = self.journal.state
            self.report.event(
                "journal_recover", finished=len(st.finished),
                in_flight=len(st.in_flight), queued=len(st.queued),
                poisoned=len(st.poisoned))
        sched.open(cfg.target_live)
        try:
            while True:
                self._apply_fences()
                self._introspect()
                if (self.preemption is not None
                        and self.preemption.requested
                        and not self._draining):
                    self._draining = True
                    # wake producers promptly: put-retry loops get
                    # QueueClosed, wait_* calls return instead of
                    # spinning out their timeouts
                    self.queue.close()
                    self.report.event(
                        "drain", queued=len(self.queue),
                        live=sched.n_live,
                        reason="preemption requested; finishing in-flight "
                               "sessions, queue left for the rerun")
                if not self._draining:
                    self._admit_due_requeues()
                    src_live = self._refill(src, src_live)
                    if not src_live and not keep_open:
                        self._intake_open = False
                    if (not sched.has_work and self._intake_open
                            and len(self.queue) < cfg.target_live):
                        # idle engine, open intake, short queue: hold the
                        # admission window open so arrivals GANG into one
                        # phase-aligned admission (one stacked bucket
                        # dispatch) instead of trickling in one at a time.
                        # Under the planner the window is ADAPTIVE —
                        # predicted marginal arrival wait vs per-class
                        # SLO headroom (serve.planner.admission_hold),
                        # with an explicit admit_window_s as the floor.
                        # Bounded, so a drain request is seen at worst
                        # one window later; a busy engine never waits
                        # here.
                        window = cfg.admit_window_s
                        hold = 0.0
                        if self.planner is not None:
                            hold = self.planner.admission_hold_s(
                                free=cfg.target_live - sched.n_live,
                                queued=len(self.queue),
                                head_waits=self.queue.head_waits())
                            window = max(window, hold)
                        if window > 0:
                            ganged = self.queue.wait_at_least(
                                cfg.target_live, window)
                            # a planner DECISION event only when the
                            # planner's hold GOVERNED the window (not
                            # the fixed admit_window_s floor) and a
                            # gang actually formed under it
                            if ganged and hold > 0 and hold == window:
                                self.report.event(
                                    "admission_hold",
                                    window_s=round(hold, 4),
                                    depth=len(self.queue))
                    self._admit_up_to_target()
                if sched.has_work:
                    sched.pump()
                    self._collect(on_result)
                    continue
                # engine idle: anything left to wait for?  (a held spill
                # entry counts as queued, and so does a not-yet-due
                # backoff re-admission — neither may be dropped)
                if self._draining or (not len(self.queue)
                                      and self._spill is None
                                      and not self._requeue
                                      and not self._intake_open):
                    break
                if not len(self.queue):
                    # free slots, empty queue: wait (bounded, so a drain
                    # request is never missed) for an arrival or for the
                    # next backoff re-admission to come due
                    timeout = max(cfg.admit_window_s, 0.05)
                    if self._requeue:
                        due = min(t for t, _ in self._requeue) \
                            - time.monotonic()
                        timeout = min(timeout, max(due, 0.01))
                    self.queue.wait_nonempty(timeout)
        except BaseException:
            sched.abort()
            raise
        finally:
            sched.close()
            self.queue.close()
            self._collect(on_result)
            self._apply_fences()  # acks of releases in the final round
            # admission-ordered, whatever order completions landed in (a
            # backoff-re-admitted user keeps its FIRST admission slot)
            self.results = [sched.results[id(e)] for e in self._admitted
                            if id(e) in sched.results]
        if self._draining:
            queued = (len(self.queue) + len(self._requeue)
                      + (1 if self._spill is not None else 0))
            raise Preempted(
                f"drained: {len(self.results)} user(s) finished in-flight, "
                f"{queued} left queued — rerun to serve them")
        return self.results

    # -- internals ---------------------------------------------------------

    def _introspect(self) -> None:
        """One introspection round: refresh the status snapshot (rate
        limited inside the writer; it evaluates the alerts on the same
        cadence) and write the control-lane spans."""
        if self.status is not None:
            self.status.maybe_write(self._status_payload)
        self._ctl_spans()

    def _evaluate_alerts(self) -> list:
        from consensus_entropy_tpu_torch.obs import alerts as alerts_mod

        slo = self.planner.slo if self.planner is not None else {
            "interactive": self.config.slo_interactive_s,
            "batch": self.config.slo_batch_s}
        out = alerts_mod.slo_headroom_alerts(self.report.class_p95s(),
                                             slo)
        out += alerts_mod.batch_aging_alerts(self.queue.head_waits(),
                                             self.config.aging_s)
        breaker = self.scheduler.breaker
        if breaker is not None:
            out += alerts_mod.breaker_alerts(breaker.summary())
        return out

    def _status_payload(self) -> dict:
        """This host's live state as the status snapshot's payload (the
        JAX payload's ``jit`` section aside: the port compiles nothing at
        run time)."""
        if self.alerts is not None:
            self.alerts.update(self._evaluate_alerts())
        sched = self.scheduler
        depths = self.queue.depths()
        live_cls: dict = {}
        for c in self._live_cls.values():
            live_cls[c] = live_cls.get(c, 0) + 1
        with self._fence_lock:
            fences_pending = (len(self._fence_req) + len(self._evict_req)
                              + len(self._evicting))
        payload = {
            "queued": depths,
            "queue_total": sum(depths.values()),
            "live": sched.n_live,
            "live_cls": live_cls,
            "target_live": self.config.target_live,
            "draining": self._draining,
            "intake_open": self._intake_open,
            "fences_pending": fences_pending,
            "requeued": len(self._requeue),
            "users_done": self.report.users_done,
            "users_failed": self.report.users_failed,
        }
        if self.planner is not None:
            payload["planner"] = self.planner.summary()
        breaker = sched.breaker
        if breaker is not None:
            degraded = breaker.summary()
            if degraded:
                payload["breaker"] = {str(w): s
                                      for w, s in degraded.items()}
        per_bucket = self.report.per_bucket_occupancy
        if per_bucket is not None:
            payload["buckets"] = {str(w): b
                                  for w, b in per_bucket.items()}
        if self.alerts is not None:
            payload["alerts"] = self.alerts.active
            # the sinks' delivery failures (the --alert-sink help's count)
            payload["alert_sink_errors"] = self.alerts.sink_errors
        return payload

    def _ctl_spans(self) -> None:
        """The serve-local control-plane trace lane: journal compactions
        and breaker open/close transitions land as instant decision
        spans, keyed on the journal seq at which the transition was
        observed (``Tracer.control_event``: a restarted server
        re-observes from replayed state and the merge dedupes).
        Observation only — nothing journaled or replayed reads a span."""
        tracer = self.scheduler.tracer
        if not tracer.enabled or self.journal is None:
            return
        n = self.journal.compactions
        if n > self._ctl_compactions:
            seq = self.journal.state.seq
            for i in range(self._ctl_compactions + 1, n + 1):
                tracer.control_event("ctl.compact", key=(seq, i),
                                     compactions=i)
            self._ctl_compactions = n
        breaker = self.scheduler.breaker
        if breaker is not None:
            states = {str(w): str(s)
                      for w, s in (breaker.summary() or {}).items()}
            if states != self._ctl_breaker:
                seq = self.journal.state.seq
                for w in sorted(set(states) | set(self._ctl_breaker)):
                    old = self._ctl_breaker.get(w, "closed")
                    new = states.get(w, "closed")
                    if old != new:
                        tracer.control_event("ctl.breaker",
                                             key=(seq, w, new),
                                             width=w, state=new,
                                             prev=old)
                self._ctl_breaker = states

    def _refill(self, src, src_live: bool) -> bool:
        """Top the waiting queue up from the pull source — never past the
        producer bound, and no further than one engine's worth
        (``target_live``), so the source's per-user setup (workspace
        creation, committee loads) stays just-in-time instead of
        materializing the whole user list behind a small engine.  A held
        spill entry is flushed FIRST, unconditionally — it must reach the
        queue (or keep being held) even after the source exhausts, never
        be dropped."""
        want = min(self.queue.maxsize, self.config.target_live)
        while True:
            if self._spill is not None:
                self._resolve_class(self._spill)
                depth = self.queue.try_put(self._spill)
                if depth is None:  # producers still hold the last slot
                    return src_live
                self._note_enqueued(self._spill, depth)
                self._spill = None
            if not src_live or len(self.queue) >= want:
                return src_live
            try:
                cand = next(src)
            except StopIteration:
                return False
            if not self._skip(cand):  # finished/poisoned never re-enter
                self._spill = cand

    def _admit_up_to_target(self) -> None:
        """Refill freed engine slots from the queue — the continuous-
        batching core: admission happens the moment occupancy dips, not at
        cohort boundaries.  Each admission is journaled (the ``admit``
        transition makes the user in-flight for crash recovery) and
        counted against the user's failure budget."""
        sched = self.scheduler
        while sched.n_live < self.config.target_live:
            live: dict = {}
            for c in self._live_cls.values():
                live[c] = live.get(c, 0) + 1
            item = self.queue.pop(
                live=live, free=self.config.target_live - sched.n_live)
            if item is None:
                return
            entry, t_enq = item
            uid = str(entry.user_id)
            cls = getattr(entry, "priority", None) or DEFAULT_CLASS
            # a restarted run re-admits at the KILLED run's journaled
            # width — per-RUN pad pinning survives the process even when
            # the planner's edges have since moved
            width = self.journal.width_of(uid) \
                if self.journal is not None else None
            if width is None:
                width = self.router.width_for(entry.data.pool.n_songs)
            # a kill here models dying between the queue pop and the
            # durable admit record: the journal still shows the user
            # queued, so a restart re-enqueues it — no user is lost
            faults.fire("serve.admit", user=uid, width=width)
            self._journal("admit", uid, width=width)
            self._attempts[uid] = self._attempts.get(uid, 0) + 1
            sched.admit(entry, pad=width)
            self._live_cls[uid] = cls
            if id(entry) not in self._admitted_ids:
                self._admitted_ids.add(id(entry))
                self._admitted.append(entry)
            self._pending[id(entry)] = None
            wait_s = time.perf_counter() - t_enq
            if self.planner is not None:
                # headroom back-dates by the queue wait: the SLO clock
                # started at enqueue, not here
                self.planner.note_admit(uid, cls, waited_s=wait_s)
            self.report.admitted(
                entry.user_id, width=width, wait_s=wait_s,
                depth=len(self.queue), live=sched.n_live, cls=cls)
            tracer = sched.tracer
            if tracer.enabled:
                # the queue wait as a span under the user's root — keyed
                # by attempt so backoff re-admissions each show their
                # wait.  The queue stamps entries BEFORE the root span
                # opens, so clamp the span start inside its parent
                # (strict nesting is an export invariant).
                now = time.time()
                t0 = now - wait_s
                root_t0 = tracer.user_open_t0(uid)
                if root_t0 is not None:
                    t0 = max(t0, root_t0)
                tracer.span_at(
                    "admission_wait", t0, now,
                    parent=tracer.user_ctx(uid),
                    key=(uid, self._attempts[uid]), user=uid, width=width)

    def _admit_due_requeues(self) -> None:
        """Move backoff re-admissions whose delay elapsed back into the
        waiting queue (a full queue just postpones them — the entry keeps
        its due time and retries next round)."""
        if not self._requeue:
            return
        now = time.monotonic()
        still: list = []
        for due, entry in self._requeue:
            if due > now:
                still.append((due, entry))
                continue
            depth = self.queue.try_put(entry)
            if depth is None:
                still.append((due, entry))
                continue
            self._note_enqueued(entry, depth)
        self._requeue = still

    def _on_terminal(self, entry: FleetUser, error: str,
                     resumes: int) -> bool:
        """The scheduler's terminal-failure hook: decide between backoff
        re-admission (absorb — return True) and a FINAL failure (return
        False so the scheduler records it).  Final failures past the
        budget also land in the persisted poison list, so future submits
        skip the user."""
        uid = str(entry.user_id)
        attempts = self._attempts.get(uid, 1)
        self._live_cls.pop(uid, None)
        if self.planner is not None:
            # the user left the engine either way (requeue or final):
            # its SLO clock stops constraining holds until re-admission
            self.planner.note_resolved(uid)
        if (self._draining or entry.committee_factory is None
                or self.config.failure_budget <= 1):
            return False  # not re-admittable: record the failure now
        if attempts >= self.config.failure_budget:
            self.poison.add(uid, error=error, attempts=attempts)
            self._journal("poison", uid, error=error, attempts=attempts)
            self.report.event("poison", user=uid, error=error,
                              attempts=attempts)
            return False  # budget exhausted: record it, poisoned for good
        try:
            # reload NOW, while the evicted session's workspace is
            # quiescent: the re-admitted attempt must start from the
            # durable two-phase-committed state, not the faulted
            # in-memory committee
            entry.committee = entry.committee_factory()
        except Exception as load_err:
            # nothing to re-admit with: record the failure terminally
            self.report.event("requeue_reload_failed", user=uid,
                              error=repr(load_err))
            return False
        delay = backoff_delay(attempts - 1,
                              base_delay=self.config.backoff_base_s,
                              max_delay=self.config.backoff_max_s,
                              rng=self._backoff_rng)
        self._requeue.append((time.monotonic() + delay, entry))
        self._journal("fail", uid, error=error, attempt=attempts)
        self.report.event("requeue", user=uid, attempt=attempts,
                          delay_s=round(delay, 4), error=error)
        return True

    def _collect(self, on_result) -> None:
        """Surface newly-finished users (done or terminally failed) to
        ``on_result`` the moment they complete, in completion order —
        the serving driver persists each immediately; the admission-
        ordered ``self.results`` is assembled once at end of run.
        Failures release their slot like completions — admission never
        stalls on a failed user.  Cost is O(in-flight), not O(everything
        ever admitted)."""
        if not self._pending:
            return
        finished = [eid for eid in self._pending
                    if eid in self.scheduler.results]
        if not finished:
            return
        # a kill here models dying between engine completion and the
        # durable finish record: the journal still shows the user
        # in-flight, so a restart re-admits it and it re-finishes from its
        # final workspace (idempotently) — no user is lost
        faults.fire("serve.collect", n=len(finished))
        for eid in finished:
            self._pending.pop(eid, None)
            rec = self.scheduler.results[eid]
            self._live_cls.pop(str(rec["user"]), None)
            if self.planner is not None:
                self.planner.note_resolved(rec["user"])
            if on_result is not None:
                on_result(rec)
            if rec["error"] is None:
                # AFTER on_result: "finished" in the journal implies the
                # driver's persistence ran, so recovery may skip the user
                self._journal("finish", rec["user"])
            elif str(rec["user"]) not in self.poison:
                # a final (non-poisoned) failure stays re-admittable on
                # restart: the journal keeps the user in-flight.  The
                # ``final`` marker distinguishes it from a backoff-requeue
                # fail so a fabric coordinator tailing this journal knows
                # THIS server is done with the user (restart replay
                # deliberately ignores the marker)
                self._journal("fail", rec["user"], error=rec["error"],
                              final=True)
