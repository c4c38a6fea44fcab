"""SLO-aware admission: adaptive bucket edges, priority classes, holds.

Counterpart of ``consensus_entropy_tpu/serve/planner.py`` (``:65-392``).
The admission policy learns from the telemetry the stack records:

- **Adaptive bucket edges**: a mergeable :class:`~consensus_entropy_tpu_
  torch.obs.metrics.QuantileSketch` over enqueue-time pool sizes; every
  ``planner_epoch`` observations :func:`derive_edges` turns its quantiles
  into bucket edges (rounded up to ``PAD_MULTIPLE``, deduped) and the live
  :class:`~consensus_entropy_tpu_torch.serve.buckets.BucketRouter` is
  updated in place.  Edges apply to future admissions only: an admitted
  user's pad stays pinned for the run, across restarts too (its journaled
  ``admit`` width).  Every epoch is journaled as a ``planner`` record with
  the edges and the sketch, so a restarted server re-derives the same
  routing: it restores the last sketch and re-observes the enqueue pool
  sizes journaled after it.
- **Priority classes**: :data:`PRIORITY_CLASSES` (``interactive`` ahead
  of ``batch``); the admission queue pops strict priority with aging, the
  classes ride the journal's ``enqueue`` records, and the report keeps
  per-class admission-to-finish histograms.
- **Holds**: :func:`admission_hold` holds intake-side admission while the
  predicted arrival wait would raise the admission gang without breaching
  the most constrained waiter's SLO headroom; :func:`dispatch_hold` holds
  a partially formed stacked dispatch while host steps in flight mean
  more sessions can still join, inside the same headroom.  Holds change
  when work batches, never what it computes.

``--no-slo-planner`` (``ServeConfig.slo_planner=False``) keeps the
fixed-window admission.
"""

from __future__ import annotations

import math
import threading
import time

from consensus_entropy_tpu_torch.obs.metrics import QuantileSketch, ema
from consensus_entropy_tpu_torch.serve.buckets import PAD_MULTIPLE
from consensus_entropy_tpu_torch.utils import round_up as _round_up

#: admission priority classes, HIGHEST priority first.  ``interactive``
#: (latency-sensitive, tight SLO) pops ahead of ``batch`` (throughput
#: work, loose SLO) unless aging promotes a starved ``batch`` entry.
PRIORITY_CLASSES = ("interactive", "batch")

#: the class an unclassified user lands in (the pre-class behavior:
#: every user equal, FIFO)
DEFAULT_CLASS = "batch"


def derive_edges(sketch, *, n_buckets: int = 4,
                 pad_multiple: int = PAD_MULTIPLE) -> tuple:
    """Bucket edges from the observed pool-size distribution: the
    ``i/n``-quantiles (``i = 1..n_buckets``, so the top edge is the
    observed max), each rounded UP to ``pad_multiple``, deduped and
    sorted.  Deterministic given the sketch state — numpy-exact while the
    sketch's reservoir holds, bucket upper edges (conservative: wider,
    never tighter) after.  Pools above every edge still fall through to
    the router's power-of-two overflow, so routing stays total."""
    if not sketch.n:
        return ()
    edges = set()
    for i in range(1, n_buckets + 1):
        q = sketch.percentile(100.0 * i / n_buckets)
        if q is not None and q > 0:
            edges.add(_round_up(int(math.ceil(q)), pad_multiple))
    return tuple(sorted(e for e in edges if e > 0))


def admission_hold(*, free: int, queued: int, gap_s: float | None,
                   headroom_s: float, max_hold_s: float) -> float:
    """Seconds to hold intake-side admission open for further arrivals.

    Queueing-theory batch-forming, reduced to its decision kernel: hold
    only while the predicted marginal wait buys occupancy —

    - ``queued >= free``: the gang already fills every free slot; one
      more arrival cannot raise this admission's occupancy → 0.
    - ``gap_s`` (the observed inter-arrival EMA) is unknown or exceeds
      the SLO ``headroom_s`` of the most-constrained waiter: the
      predicted wait would breach (or is unpredictable) → 0.
    - otherwise hold for the predicted time to fill the remaining slots
      (``gap_s * (free - queued)``), clamped by the headroom and the
      operator cap.

    Pure — every input is observed telemetry, so decisions replay
    deterministically and pin in unit tests."""
    if free <= 0 or queued >= free:
        return 0.0
    if headroom_s <= 0 or gap_s is None or gap_s > headroom_s:
        return 0.0
    return min(gap_s * (free - queued), headroom_s, max_hold_s)


def dispatch_hold(*, waiting: int, host_in_flight: int,
                  headroom_s: float, max_hold_s: float,
                  step_ema_s: float | None = None) -> float:
    """Seconds to hold a partially-formed stacked dispatch.

    A session can only join the waiting batch by finishing an
    outstanding host step, so the predictor is structural: with
    ``host_in_flight == 0`` nothing more can join (hold buys nothing →
    0); with host work outstanding, holding raises expected occupancy —
    hold up to the SLO ``headroom_s`` of the most-constrained live user.

    ``step_ema_s`` — the observed host-step duration EMA (the same
    durations the obs ``host_step`` spans time; the scheduler feeds them
    back through :meth:`AdmissionPlanner.note_host_step`) — SIZES the
    hold once known: the joiners arrive when their host steps finish, so
    the predicted useful hold IS the expected step duration, not the
    flat operator cap.  A fleet whose host steps take 40 ms stops
    burning ``max_hold_s`` per hold; one whose steps take 3 s holds long
    enough to actually catch them (still inside SLO headroom).  Before
    any telemetry exists, ``max_hold_s`` remains the structural cap.
    Applies identically to reduction ScoreSteps and mid-run CNN
    ``DeviceStep`` cohorts (both wait in the scheduler's score-wait
    list).  Pure, like :func:`admission_hold`."""
    if waiting <= 0 or host_in_flight <= 0:
        return 0.0
    if headroom_s <= 0 or max_hold_s <= 0:
        # max_hold_s=0 stays the operator's OFF switch even once
        # telemetry exists (the pre-EMA semantics)
        return 0.0
    if step_ema_s is not None:
        return min(max(step_ema_s, 0.0), headroom_s)
    return min(headroom_s, max_hold_s)


class AdmissionPlanner:
    """The serve layer's learning admission policy (see module doc).

    One planner per :class:`~consensus_entropy_tpu_torch.serve.server.
    FleetServer`; the server feeds it enqueue/admit/finish transitions
    and consults it for the admission hold, the router consults it
    (indirectly — the planner updates the router in place) for edges,
    and the scheduler consults :meth:`window_s` for the dispatch hold.

    ``journal``: the admission journal (may be ``None``); construction
    RESTORES from its replayed state — last journaled sketch + the
    enqueue pool sizes journaled after it — so edges re-derive
    identically across restarts.  ``clock`` is injectable for tests.
    """

    def __init__(self, config, *, router, journal=None, report=None,
                 clock=time.monotonic):
        self.slo = {"interactive": config.slo_interactive_s,
                    "batch": config.slo_batch_s}
        self.epoch = config.planner_epoch
        self.n_buckets = config.planner_buckets
        self.max_hold_s = config.max_hold_s
        #: explicit operator edges win: the planner still sketches (and
        #: journals) but never overrides a configured router
        self.adapt_edges = config.bucket_widths is None
        self.router = router
        self.journal = journal
        self.report = report
        self._clock = clock
        self.sketch = QuantileSketch()
        self.edges: tuple = ()
        self.edge_updates = 0
        self.admission_hold_rounds = 0
        self.dispatch_hold_rounds = 0
        self._holding = False
        self._gap_ema: float | None = None
        self._last_enq_t: float | None = None
        #: host-step duration EMA (the scheduler feeds completed-step
        #: walls back through :meth:`note_host_step`): sizes dispatch
        #: holds from telemetry instead of the flat ``max_hold_s`` cap
        self._step_ema: float | None = None
        #: live (admitted, unfinished) users: uid -> (class, admit_t)
        self._live: dict[str, tuple] = {}
        #: enqueue observations arrive from producer threads
        #: (``FleetServer.submit``) AND the serve loop — one lock covers
        #: the sketch, the arrival EMA and the epoch derivation (which
        #: appends to the journal; the journal has its own lock)
        self._lock = threading.Lock()
        #: True while :meth:`_restore` replays the journal tail —
        #: derivations then update state but never journal (see
        #: _restore's ordering note)
        self._restoring = False
        if journal is not None:
            self._restore()

    # -- restart restore ---------------------------------------------------

    def _restore(self) -> None:
        """Rebuild the planner from the replayed journal: the last
        ``planner`` record's sketch + edges, then the enqueue pool sizes
        journaled after it (re-observed through the normal path, so an
        epoch boundary the crash interrupted re-derives now).

        Journaling is SUPPRESSED while the tail replays — a planner
        record appended mid-restore would land AFTER enqueue records it
        does not cover (the tail's remainder), and the next replay's
        ``pool_obs`` reset at that record would silently drop them.
        Instead, ONE covering record is appended after the whole tail
        re-observed, so every planner record in the file covers every
        enqueue record before it; a crash mid-restore appends nothing
        and the next restore repeats deterministically."""
        edges, sketch, pool_obs = self.journal.planner_state()
        if sketch:
            self.sketch = QuantileSketch.from_dict(sketch)
        if edges and self.adapt_edges:
            # explicit operator edges win even over a journal written by
            # an earlier adaptive run — never restore edges the router
            # is not using
            self.edges = tuple(int(e) for e in edges)
            self.router.update(self.edges)
        self._restoring = True
        try:
            for pool in pool_obs:
                self.observe_enqueue(pool)
        finally:
            self._restoring = False
        if pool_obs:
            with self._lock:
                self.journal.append("planner", edges=list(self.edges),
                                    sketch=self.sketch.to_dict())

    # -- telemetry intake --------------------------------------------------

    def observe_enqueue(self, pool_size, t: float | None = None,
                        journal_entry=None) -> None:
        """One enqueue observation: fold the pool size into the sketch
        (deriving + journaling edges at epoch boundaries) and, when a
        wall-time ``t`` is given (live enqueues — replay passes none),
        update the inter-arrival EMA the admission hold predicts with.

        ``journal_entry``: nullary callable appending the enqueue's OWN
        journal record — run inside this planner's lock, immediately
        before the observation, so the two commit atomically: a planner
        epoch record can then never omit an enqueue journaled before it
        (concurrent producers would otherwise race the epoch boundary
        and break the restart-identical-edges contract)."""
        with self._lock:
            if journal_entry is not None:
                journal_entry()
            if t is not None:
                if self._last_enq_t is not None:
                    self._gap_ema = ema(self._gap_ema,
                                        max(t - self._last_enq_t, 0.0))
                self._last_enq_t = t
            if pool_size is None:
                return
            self.sketch.add(int(pool_size))
            if self.sketch.n % self.epoch == 0:
                self._derive()

    def _derive(self) -> None:
        """One planner epoch: re-derive edges from the sketch, update the
        live router on change, and journal the epoch (edges + sketch
        state) so replay reconstructs this exact planner.  The journal
        record is appended even when the edges did not change — it resets
        the replay tail (``pool_obs``) and bounds what a restart must
        re-observe; the metrics event fires only on change.  With
        explicit operator edges (``adapt_edges=False``) no edges are
        derived or reported at all — the sketch still journals, but the
        planner never claims edges the router is not using."""
        if self.adapt_edges:
            edges = derive_edges(self.sketch, n_buckets=self.n_buckets)
            if edges and edges != self.edges:
                self.edges = edges
                self.edge_updates += 1
                self.router.update(edges)
                if self.report is not None:
                    self.report.event("planner_edges", edges=list(edges),
                                      observations=self.sketch.n)
        if self.journal is not None and not self._restoring:
            self.journal.append("planner", edges=list(self.edges),
                                sketch=self.sketch.to_dict())

    def note_host_step(self, dur_s: float) -> None:
        """One completed host step's wall duration (submit → completion,
        the same interval the obs ``host_step`` span times): folds into
        the EMA that SIZES dispatch holds — telemetry-predicted holds
        instead of the flat ``max_hold_s`` cap (the scheduler calls this
        from its drain loop)."""
        with self._lock:
            self._step_ema = ema(self._step_ema,
                                 max(float(dur_s), 0.0))

    def note_admit(self, user, cls: str, waited_s: float = 0.0) -> None:
        """The user took a slot; ``waited_s`` is the queue wait it
        already spent — the SLO latency clock starts at enqueue, so the
        user's headroom is back-dated by the wait (a user that queued
        55 s of a 60 s SLO has 5 s of hold headroom left, not 60)."""
        self._live[str(user)] = (cls, self._clock() - max(waited_s, 0.0))

    def note_resolved(self, user) -> None:
        """The user finished or failed terminally: its SLO clock stops
        constraining holds."""
        self._live.pop(str(user), None)

    # -- hold decisions ----------------------------------------------------

    def headroom_s(self, head_waits: dict | None = None) -> float:
        """SLO headroom of the most-constrained user a hold would delay:
        min over live (admitted) users of ``slo[class] - age``, and over
        the queue heads' ``(class, waited)`` pairs when given.  With
        nobody to constrain, the loosest class target."""
        now = self._clock()
        default = min(self.slo.values())
        vals = [self.slo.get(cls, default) - (now - t)
                for cls, t in self._live.values()]
        for cls, waited in (head_waits or {}).items():
            vals.append(self.slo.get(cls, default) - waited)
        return min(vals) if vals else max(self.slo.values())

    def admission_hold_s(self, *, free: int, queued: int,
                         head_waits: dict | None = None) -> float:
        hold = admission_hold(free=free, queued=queued,
                              gap_s=self._gap_ema,
                              headroom_s=self.headroom_s(head_waits),
                              max_hold_s=self.max_hold_s)
        if hold > 0:
            self.admission_hold_rounds += 1
        return hold

    def window_s(self, waiting: int, host_in_flight: int) -> float:
        """The scheduler-side dispatch-hold policy (installed as
        ``FleetScheduler.hold``): see :func:`dispatch_hold`.  The
        counter counts hold PERIODS (a 0→held transition), not pump
        consults — the scheduler re-asks every loop round while one
        hold is in progress."""
        hold = dispatch_hold(waiting=waiting,
                             host_in_flight=host_in_flight,
                             headroom_s=self.headroom_s(),
                             max_hold_s=self.max_hold_s,
                             step_ema_s=self._step_ema)
        if hold > 0 and not self._holding:
            self.dispatch_hold_rounds += 1
        self._holding = hold > 0
        return hold

    # -- reporting ---------------------------------------------------------

    def summary(self) -> dict:
        """The ``planner`` section of the fleet summary: current edges,
        derivation and hold activity."""
        out = {
            "edges": list(self.edges) if self.edges else None,
            "edge_updates": self.edge_updates,
            "observations": self.sketch.n,
            "admission_hold_rounds": self.admission_hold_rounds,
            "dispatch_hold_rounds": self.dispatch_hold_rounds,
            "slo_s": dict(sorted(self.slo.items())),
            "host_step_ema_s": (round(self._step_ema, 4)
                                if self._step_ema is not None else None),
        }
        return out
