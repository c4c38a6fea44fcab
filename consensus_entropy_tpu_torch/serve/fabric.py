"""The multi-host serve fabric: journal-coordinated user sharding with
lease-based host failover.

Counterpart of ``consensus_entropy_tpu/serve/fabric.py`` (``:149-2625``),
all of it: its records, fault points and files are the JAX package's, so
a fabric directory either package wrote replays in the other.  One
coordinator process shards admitted users across worker processes, each
running its own :class:`~consensus_entropy_tpu_torch.serve.server.
FleetServer` over its devices.  The admission journal stays the source of
truth:

- the coordinator is its sole writer: ``enqueue`` records as users are
  accepted, ``assign(user, host)`` routing records, host ``lease`` /
  ``revoke`` membership records, and each worker's own event journal
  (``admit`` / ``finish`` / ``fail`` / ``poison``, tailed partial-line
  safe) transcribed with ``host`` and ``src_off`` fields, so the main
  journal replays into the whole fabric state and the transcription
  cursor survives a coordinator crash;
- workers heartbeat through per-host lease files (:mod:`serve.hosts`);
  coordination is through files, with no process group;
- on lease expiry or worker death the coordinator SIGKILLs the host and
  confirms it dead before any user moves, drains its durable events,
  appends ``revoke`` and re-routes its unresolved users to the surviving
  hosts, in-flight users first (they resume from their workspaces), then
  queued users in enqueue order.  A user runs on one live host at a time
  and resume replays its two-phase-committed workspace, so its result is
  its uninterrupted run's.

A restarted coordinator replays the journal, reaps orphan workers through
their lease pids, spawns fresh hosts and re-routes every unresolved user.
Compaction bounds the journal.

The elastic plane (``FabricConfig.min_hosts`` / ``max_hosts``;
:mod:`serve.elastic`, :mod:`serve.placement`): the autoscaler replaces
dead capacity and scales up on backlog and SLO headroom, each decision
journaled (``spawn``); a fresh or operator-started host joins through
the lease directory and queued users rebalance onto it over an ack-gated
drop protocol; users route by bucket-aware placement; the fleet planner
merges the workers' sketches into one broadcast edge set; graceful
scale-down (``scale_down_s``) drains a surplus host, its queued users
rebalanced and its in-flight users migrated through checkpoint fences
(only the worker's journaled fence ack, with the checkpoint generation,
commits the re-assign), and retires it (``drain_done``).

The self-healing plane (``remedy``, ``fence_deadline_s``, ``gray``,
``hold_on_burn``; :mod:`serve.remedy`, :mod:`obs.alerts`): a sustained
placement-skew alert sheds the overloaded host's surplus users without
retiring it; a fence not acked within the deadline demotes to
evict+resume; the gray ladder walks a slow-but-alive host through
probation to a drain; a burning SLO class defers routing for a while.
Every action is ack-gated and derives from journaled state, so a
coordinator killed anywhere replays to the same action sequence and no
user is moved twice.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import re
import signal
import threading
import time

from consensus_entropy_tpu_torch.fleet.report import FleetReport
from consensus_entropy_tpu_torch.obs.metrics import ema as metrics_ema
from consensus_entropy_tpu_torch.resilience import faults
from consensus_entropy_tpu_torch.resilience import io as dio
from consensus_entropy_tpu_torch.serve import placement as placement_mod
from consensus_entropy_tpu_torch.serve.elastic import (
    FleetPlanner,
    PidProc,
    drain_victim,
    next_host_id,
    scale_down_ok,
    target_hosts,
)
from consensus_entropy_tpu_torch.serve.hosts import (
    fabric_paths,
    lease_age_s,
    read_lease,
)
from consensus_entropy_tpu_torch.serve.journal import (
    JsonlTail,
    PoisonList,
    _AppendFsyncFile,
)
from consensus_entropy_tpu_torch.serve import remedy as remedy_mod
from consensus_entropy_tpu_torch.serve.placement import (
    DEFAULT_MAX_SKEW,
    PLACEMENT_POLICIES,
)
from consensus_entropy_tpu_torch.serve.server import QueueClosed, QueueFull

#: per-class latency samples the burn detector keeps (enough for a
#: stable p95, small enough that old load shapes age out fast)
HOLD_WINDOW = 64


class FabricError(RuntimeError):
    """The fabric cannot make progress (every worker host is down with
    users still unresolved).  All state is durable: rerunning the
    coordinator resumes from the journal."""


@dataclasses.dataclass
class FabricConfig:
    """Coordinator policy knobs.

    ``hosts``: worker host processes to spawn.  ``lease_s``: heartbeat
    lease — a worker whose last beat is older than this is declared dead
    (killed + failed over); workers beat at a third of it.  ``poll_s``:
    coordinator loop period (transcription + liveness checks).
    ``spawn_grace_s``: how long a fresh worker may take to publish its
    FIRST heartbeat (process start, torch import and the device's first calls) before it is presumed
    stillborn.  ``drain_timeout_s``: how long the graceful close waits
    for idle workers to exit before SIGKILLing them (their work is done
    and durable by then — the kill is cosmetic).

    ELASTIC control-plane knobs (``serve.elastic``; setting
    ``min_hosts``/``max_hosts`` turns the autoscaler + JOIN/rebalance +
    fleet planner ON — unset, the fabric behaves as a static fleet):
    ``min_hosts``/``max_hosts``: the autoscaler's fleet-size clamp —
    dead capacity below the floor is respawned, scale-up stops at the
    ceiling.  ``scale_backlog``: queued users per live host past which
    the queue-depth signal scales up; ``scale_slo_s``: predicted
    queue-drain seconds (observed finish EMA × backlog) past which the
    SLO-headroom signal scales up (0 disables).  ``placement``: the
    cross-host routing arm — ``bucket`` co-locates same-dispatch-bucket
    users so stacked dispatches stay full per host, ``load`` keeps the
    least-loaded rule.  ``planner_epoch`` /
    ``planner_buckets``: the fabric-level planner's derivation cadence
    over the MERGED per-host quantile sketches (``fleet_planner=False``
    keeps per-host edges independent — also forced off when workers run
    explicit ``--bucket-widths``).

    All validated at CONSTRUCTION (the ``validate_bucket_widths``
    precedent): a typo'd geometry fails here with the reason, not as a
    wedged fabric minutes in."""

    hosts: int = 2
    lease_s: float = 5.0
    poll_s: float = 0.05
    spawn_grace_s: float = 120.0
    drain_timeout_s: float = 60.0
    min_hosts: int | None = None
    max_hosts: int | None = None
    scale_backlog: int = 8
    scale_slo_s: float = 0.0
    #: graceful SCALE-DOWN (0 = off, a grow-only autoscaler):
    #: once the low-water mark (``elastic.scale_down_ok`` — both
    #: scale-up signals quiet at ``live - 1``) holds for this many
    #: CONTINUOUS seconds and live hosts exceed ``min_hosts``, one
    #: surplus host drains: the decision is journaled (``drain``), the
    #: host stops admitting, its queued users rebalance away over the
    #: drop-ack path, its in-flight users finish or migrate
    #: (``migrate_inflight``), and the host retires clean
    #: (``drain_done``) — replay-identical after a coordinator SIGKILL
    #: at any boundary
    scale_down_s: float = 0.0
    #: OPERATOR drain command (``--drain-host h3``): drain this host through exactly the journaled
    #: scale-down machinery — same ``drain`` record, same fault point,
    #: same drop-ack/fence shed, same ``drain_done`` retirement — but
    #: initiated by the operator instead of the low-water mark (no
    #: ``scale_down_s`` needed, and the ``min_hosts`` floor is NOT
    #: applied: the operator said so).  One-shot per run; requires the
    #: elastic plane (the shed paths are its machinery).
    drain_host: str | None = None
    #: checkpoint-fenced IN-FLIGHT migration during a drain: the source
    #: session checkpoints at its next iteration boundary, the worker
    #: journals a fence ack carrying the checkpoint generation, and only
    #: that ack commits the re-assign — the target resumes the fenced
    #: workspace bit-identically.  ``False`` is drain-by-waiting (the
    #: baseline arm): in-flight users simply
    #: finish on the draining host
    migrate_inflight: bool = True
    placement: str = "bucket"
    fleet_planner: bool = True
    planner_epoch: int = 8
    planner_buckets: int = 4
    #: chips per worker host (the pool-mesh width each spawned worker
    #: serves with): an int applies fleet-wide; a tuple gives per-host
    #: widths and its length MUST equal ``hosts`` — a 4-entry shape over
    #: a 3-host fleet is a config typo that fails here, not as a worker
    #: crash-loop.  Workers advertise their width in every heartbeat;
    #: devices-aware placement then routes wide-pool buckets toward the
    #: multi-chip hosts.  Autoscaler respawns/scale-ups past the initial
    #: shape default to 1 chip (:meth:`devices_for`).
    mesh_devices: int | tuple = 1
    #: DEADLINE-FENCED degradation (0 = wait forever): a checkpoint fence not acked within this many seconds
    #: falls back to evict+resume — the coordinator journals the timeout
    #: (``remedy`` record, action ``fence_timeout``), demotes the fence,
    #: and sends an evict drop; the session releases at its next STEP
    #: boundary (any step, not the iteration checkpoint) and resumes
    #: elsewhere from its last committed generation.  One long iteration
    #: can then never hold a migration open past the deadline plus one
    #: poll interval.  Requires the elastic plane (fences are its
    #: machinery).
    fence_deadline_s: float = 0.0
    #: the REMEDIATION plane (``serve.remedy``): act on sustained
    #: placement-skew alerts with a journaled drain-for-rebalance — the
    #: overloaded host sheds just enough users (queued via drop-acks,
    #: in-flight via checkpoint fences) to return inside the skew bound,
    #: WITHOUT retiring.  Every action is ack-gated and derives from
    #: journaled state, so a coordinator SIGKILL mid-remediation replays
    #: to the identical action sequence.  Requires the elastic plane.
    remedy: bool = False
    #: hysteresis: the skew condition must hold CONTINUOUSLY this long
    #: before a remediation fires (transient imbalance self-resolves)
    remedy_hold_s: float = remedy_mod.DEFAULT_HOLD_S
    #: minimum seconds between remediations (fleet-wide): the previous
    #: wave's moves must land before the loads justify another
    remedy_cooldown_s: float = remedy_mod.DEFAULT_COOLDOWN_S
    #: the skew bound the remediation restores (and the placement-skew
    #: alert fires past) — matches placement's admission-side bound, so
    #: a shed never undoes what placement would redo
    remedy_skew: int = DEFAULT_MAX_SKEW
    #: LIVE-INTAKE bound (``run(..., keep_open=True)``): how many
    #: submitted-but-unpumped users the coordinator's intake may hold
    #: before :meth:`FabricCoordinator.submit` raises ``QueueFull`` —
    #: the fabric-level backpressure surface trace drivers retry against
    intake_max: int = 64
    #: the BURN-RATE admission hold (alert to remedy): when a priority class's observed
    #: end-to-end p95 has burned past ``obs.alerts.BURN_FRAC`` of its
    #: SLO target CONTINUOUSLY for ``remedy_hold_s`` (and the
    #: ``remedy_cooldown_s`` fleet-wide cooldown elapsed), the
    #: coordinator journals one ``remedy`` record (action
    #: ``admission_hold``; the ``fabric.remedy`` fault point fires
    #: first) and DEFERS ROUTING of newly-submitted users for
    #: ``admission_hold_s`` — arrivals stay journaled and durable, they
    #: just don't land on workers until the backlog drains.  Remedy
    #: records are audit-only on replay, so a kill at the fault point
    #: replays to the identical dispositions.
    hold_on_burn: bool = False
    #: how long one admission hold defers routing
    admission_hold_s: float = 2.0
    #: per-class end-to-end SLO targets the burn detector grades
    #: against (defaults mirror ``ServeConfig``)
    slo_interactive_s: float = 60.0
    slo_batch_s: float = 600.0
    #: the GRAY-FAILURE ladder (``obs.alerts.gray_suspect_alerts`` +
    #: the ``serve.remedy`` gray kernels): detect hosts that are SLOW
    #: RELATIVE TO THEIR PEERS (journal-append age, fence-ack lag,
    #: lease-age skew, step-wall EMA — none of which a liveness lease
    #: catches, because the host still beats) and walk a journaled
    #: suspicion → probation → drain ladder, each rung gated on
    #: sustained evidence.  Probation records replay
    #: (``JournalState.probation``), so a coordinator SIGKILL mid-ladder
    #: restarts at the same rung.  Requires the elastic plane (the
    #: drain rung is its drop-ack/fence machinery).
    gray: bool = False
    #: peer-relative outlier gates (see ``obs.alerts.GRAY_RATIO`` /
    #: ``GRAY_MIN_ABS_S``): a signal fires at ``gray_ratio`` times the
    #: peer median AND at least ``gray_min_s`` absolute
    gray_ratio: float = 3.0
    gray_min_s: float = 1.0
    #: ladder hysteresis: continuous suspect evidence for
    #: ``gray_hold_s`` → probation; ``gray_drain_s`` MORE → drain the
    #: host's users; clean for ``gray_clear_s`` → probation lifts
    gray_hold_s: float = remedy_mod.DEFAULT_GRAY_HOLD_S
    gray_drain_s: float = remedy_mod.DEFAULT_GRAY_DRAIN_S
    gray_clear_s: float = remedy_mod.DEFAULT_GRAY_CLEAR_S
    #: DEGRADATION dial: a probation host under sustained slo_headroom
    #: burn is told to score with the cheap committee stage
    #: (``depth: cheap`` feed verb → ``Committee.depth_cap``), restored
    #: when the burn clears or probation lifts.  Default OFF: capping
    #: committee depth changes scores, so parity-pinned runs leave it
    #: off (the dial's own test covers it).
    depth_on_burn: bool = False
    depth_hold_s: float = remedy_mod.DEFAULT_DEPTH_HOLD_S

    @property
    def elastic(self) -> bool:
        """True when the elastic control plane (autoscaler, JOIN +
        rebalance, operator adoption) is active."""
        return self.min_hosts is not None or self.max_hosts is not None

    def devices_for(self, index: int) -> int:
        """Chips the ``index``-th spawned worker serves with: the
        per-host tuple entry when one was given (scale-ups past the
        initial shape default to 1 chip — heterogeneity is declared up
        front, respawns of a NAMED slot keep its width), the fleet-wide
        int otherwise."""
        if isinstance(self.mesh_devices, tuple):
            return (self.mesh_devices[index]
                    if 0 <= index < len(self.mesh_devices) else 1)
        return self.mesh_devices

    def __post_init__(self):
        if self.hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {self.hosts}")
        if self.lease_s <= 0:
            raise ValueError(f"lease_s must be > 0, got {self.lease_s}")
        if self.poll_s <= 0:
            raise ValueError(f"poll_s must be > 0, got {self.poll_s}")
        if self.elastic:
            # one bound given defaults the other to the initial size, so
            # `--min-hosts 2` alone means "never shrink below 2"
            if self.min_hosts is None:
                self.min_hosts = min(self.hosts, self.max_hosts)
            if self.max_hosts is None:
                self.max_hosts = max(self.hosts, self.min_hosts)
            if self.min_hosts < 1:
                raise ValueError(f"min_hosts must be >= 1, "
                                 f"got {self.min_hosts}")
            if self.min_hosts > self.max_hosts:
                raise ValueError(
                    f"min_hosts must be <= max_hosts, got "
                    f"{self.min_hosts} > {self.max_hosts}")
            if not self.min_hosts <= self.hosts <= self.max_hosts:
                raise ValueError(
                    f"hosts={self.hosts} must sit inside "
                    f"[min_hosts={self.min_hosts}, "
                    f"max_hosts={self.max_hosts}]")
            if self.scale_backlog < 1:
                raise ValueError(f"scale_backlog must be >= 1, "
                                 f"got {self.scale_backlog}")
            if self.scale_slo_s < 0:
                raise ValueError(f"scale_slo_s must be >= 0, "
                                 f"got {self.scale_slo_s}")
            if self.scale_down_s < 0:
                raise ValueError(f"scale_down_s must be >= 0, "
                                 f"got {self.scale_down_s}")
        elif self.scale_down_s:
            raise ValueError(
                "scale_down_s requires the elastic control plane "
                "(set min_hosts/max_hosts)")
        if self.drain_host is not None and not self.elastic:
            raise ValueError(
                "drain_host requires the elastic control plane "
                "(set min_hosts/max_hosts — the drain shed paths are "
                "its machinery)")
        if self.fence_deadline_s < 0:
            raise ValueError(f"fence_deadline_s must be >= 0, "
                             f"got {self.fence_deadline_s}")
        if self.fence_deadline_s and not self.elastic:
            raise ValueError(
                "fence_deadline_s requires the elastic control plane "
                "(set min_hosts/max_hosts — checkpoint fences are its "
                "machinery)")
        if self.remedy and not self.elastic:
            raise ValueError(
                "remedy requires the elastic control plane (set "
                "min_hosts/max_hosts — the drop-ack and fence shed "
                "paths are its machinery)")
        if self.remedy_hold_s < 0 or self.remedy_cooldown_s < 0:
            raise ValueError(
                f"remedy_hold_s and remedy_cooldown_s must be >= 0, got "
                f"{self.remedy_hold_s} / {self.remedy_cooldown_s}")
        if self.remedy_skew < 1:
            raise ValueError(f"remedy_skew must be >= 1, "
                             f"got {self.remedy_skew}")
        if self.gray and not self.elastic:
            raise ValueError(
                "gray requires the elastic control plane (set "
                "min_hosts/max_hosts — the drain rung is its drop-ack "
                "and fence machinery)")
        if self.gray_ratio < 1:
            raise ValueError(f"gray_ratio must be >= 1, "
                             f"got {self.gray_ratio}")
        if self.gray_min_s < 0:
            raise ValueError(f"gray_min_s must be >= 0, "
                             f"got {self.gray_min_s}")
        if self.gray_hold_s < 0 or self.gray_drain_s < 0 \
                or self.gray_clear_s < 0:
            raise ValueError(
                f"gray_hold_s/gray_drain_s/gray_clear_s must be >= 0, "
                f"got {self.gray_hold_s} / {self.gray_drain_s} / "
                f"{self.gray_clear_s}")
        if self.depth_on_burn and not self.gray:
            raise ValueError(
                "depth_on_burn requires the gray ladder (set gray=True "
                "— the dial only ever degrades probation hosts)")
        if self.depth_hold_s < 0:
            raise ValueError(f"depth_hold_s must be >= 0, "
                             f"got {self.depth_hold_s}")
        if self.intake_max < 1:
            raise ValueError(f"intake_max must be >= 1, "
                             f"got {self.intake_max}")
        if self.admission_hold_s <= 0:
            raise ValueError(f"admission_hold_s must be > 0, "
                             f"got {self.admission_hold_s}")
        if self.slo_interactive_s <= 0 or self.slo_batch_s <= 0:
            raise ValueError("per-class SLO targets must be > 0, got "
                             f"interactive={self.slo_interactive_s} "
                             f"batch={self.slo_batch_s}")
        if self.placement not in PLACEMENT_POLICIES:
            raise ValueError(f"placement must be one of "
                             f"{PLACEMENT_POLICIES}, got {self.placement!r}")
        if isinstance(self.mesh_devices, (list, tuple)):
            self.mesh_devices = tuple(int(d) for d in self.mesh_devices)
            if len(self.mesh_devices) != self.hosts:
                raise ValueError(
                    f"mesh_devices shape {self.mesh_devices} names "
                    f"{len(self.mesh_devices)} hosts but hosts="
                    f"{self.hosts} — give one chips-per-host entry per "
                    f"spawned worker (or a single int fleet-wide)")
            if any(d < 1 for d in self.mesh_devices):
                raise ValueError(f"every mesh_devices entry must be "
                                 f">= 1, got {self.mesh_devices}")
        elif int(self.mesh_devices) < 1:
            raise ValueError(f"mesh_devices must be >= 1, "
                             f"got {self.mesh_devices}")
        else:
            self.mesh_devices = int(self.mesh_devices)
        if self.planner_epoch < 1 or self.planner_buckets < 1:
            raise ValueError("planner_epoch and planner_buckets must be "
                             f">= 1, got {self.planner_epoch} / "
                             f"{self.planner_buckets}")


class _EpochFeed:
    """Assignment-feed writer that stamps the coordinator's fencing
    epoch (``ep``) on every line.  Workers latch the highest epoch seen
    and reject lines below it, so a wedged predecessor's late writes can
    never route users after a successor took over — the single-owner
    invariant extended from SIGKILL to double-start.  Everything else
    (``close``/``rotate``/``size``/``path``) passes through to the
    wrapped :class:`~consensus_entropy_tpu_torch.serve.journal.
    _AppendFsyncFile`."""

    def __init__(self, inner, epoch: int):
        self._inner = inner
        self.epoch = int(epoch)

    def append(self, rec: dict) -> None:
        self._inner.append({**rec, "ep": self.epoch})

    def __getattr__(self, name):
        return getattr(self._inner, name)


@dataclasses.dataclass(eq=False)
class HostHandle:
    """Coordinator-side view of one worker host process."""

    host_id: str
    proc: object  # Popen-like: pid / poll() / kill() / wait(timeout)
    assign: _AppendFsyncFile
    tail: JsonlTail
    lease_path: str
    spawned_t: float
    alive: bool = True
    closed: bool = False  # close sentinel sent (clean rc=0 expected)
    #: first heartbeat observed — the elastic JOIN trigger (journaled
    #: once, then queued users rebalance onto the joiner)
    joined: bool = False
    #: scale-down in progress: the host stops receiving assignments and
    #: sheds its users until it retires (``drain_done``)
    draining: bool = False
    #: tail of the worker's ``spans_<h>.jsonl`` (None when the
    #: coordinator runs untraced)
    span_tail: JsonlTail | None = None
    #: chips-per-host the worker advertises in its heartbeat (read at
    #: JOIN); ``None`` until the first beat or for legacy workers —
    #: devices-aware placement treats it as 1
    devices: int | None = None
    #: corrupt event-WAL lines already surfaced as ``record_quarantined``
    #: (the tail's counter high-water mark)
    corrupt_seen: int = 0


class FabricCoordinator:
    """Shard users across worker hosts through the admission journal.

    ``journal``: the main :class:`~consensus_entropy_tpu_torch.serve.journal.
    AdmissionJournal` (must be file-backed — it IS the fabric's source of
    truth; give it ``compact_bytes`` to bound it for long-lived fabrics).
    ``fabric_dir``: directory for the per-host assign/events/lease
    channels.  ``poison``: the fabric-wide persisted poison list
    (transcribed worker poisons land here; poisoned users are never
    routed again).  ``on_poll``: test hook called once per
    coordinator loop with the coordinator itself (chaos drills kill
    workers from here at journal-state-defined instants).
    """

    def __init__(self, journal, fabric_dir: str, config: FabricConfig, *,
                 poison: PoisonList | None = None,
                 report: FleetReport | None = None, on_poll=None,
                 preemption=None, tracer=None, clock=time.time,
                 status=None, alerts=None, introspect: bool = True):
        if journal.path is None:
            raise ValueError("the fabric journal must be file-backed — it "
                             "is the coordinator's source of truth")
        self.journal = journal
        self.fabric_dir = fabric_dir
        self.config = config
        #: this incarnation's fencing epoch — one greater than any the
        #: journal has seen, claimed DURABLY at the top of ``run`` (the
        #: ``fabric.epoch`` fault point fires first).  Every assignment-
        #: feed line carries it; workers latch the highest seen and
        #: reject older lines, and acks echo it back so this coordinator
        #: never commits a hand-off another incarnation negotiated.
        self.epoch = journal.state.coordinator_epoch + 1
        self.poison = poison if poison is not None else PoisonList()
        self.report = report or FleetReport()
        self.on_poll = on_poll
        #: optional guard with a boolean ``requested`` (``resilience.
        #: preemption.PreemptionGuard``): SIGTERM drains the fabric —
        #: workers are SIGTERMed (their own guards finish in-flight
        #: sessions and exit 75), the finishes are transcribed, and
        #: ``Preempted`` surfaces so the CLI exits 75 with every queued
        #: user durable in the journal for the rerun
        self.preemption = preemption
        #: optional ``obs.trace.Tracer``: worker span WALs
        #: (``fabric/spans_<h>.jsonl``) are tailed and transcribed into
        #: this tracer's own sink — the span-side sibling of the event
        #: transcription, so one merged file holds the fleet timeline
        self.tracer = tracer
        #: the live introspection plane (``introspect=False`` turns
        #: every limb off at once): control-plane spans (gated here),
        #: the coordinator's status snapshot writer
        #: (``obs.status.StatusWriter`` or None) and the SLO burn-rate alert
        #: watcher (``obs.alerts.AlertWatcher`` or None).
        #: Introspection changes what operators can SEE, never results.
        self.introspect = introspect
        self.status = status if introspect else None
        self.alerts = alerts if introspect else None
        #: the injected WALL clock (lease files cross processes, so
        #: monotonic clocks don't compare): every liveness deadline —
        #: lease age, spawn grace, drain timeouts, orphan-reap polls —
        #: reads through this seam, pinnable in tests and drills.
        #: Liveness is runtime-only; journal replay never reads a clock.
        self._clock = clock
        self.hosts: dict[str, HostHandle] = {}
        self.reassignments = 0
        self.revocations = 0
        self.spawns = 0
        self.joins = 0
        self.migrations = 0
        self.drains = 0
        self.fences = 0
        self._unresolved: set[str] = set()
        self._failed: set[str] = set()
        self._submitted: list[str] = []
        #: the spawn callable ``run`` was given (the autoscaler respawns
        #: through it mid-loop)
        self._spawn_fn = None
        #: in-progress rebalance migrations awaiting the source host's
        #: drop-ack: uid → target host id.  Decisions derive from
        #: journaled state only; the ack makes the hand-off race-free (a
        #: user the worker admitted first refuses the drop and stays)
        self._migrating: dict[str, str] = {}
        #: in-progress IN-FLIGHT migrations awaiting the source host's
        #: checkpoint-fence ack: uid → source host id.  Only a positive
        #: journaled ack commits the re-assign (the fenced workspace is
        #: the resume unit); stale acks after a restart are cursor-only,
        #: exactly like stale drop acks — no user ever runs on two hosts
        self._fencing: dict[str, str] = {}
        #: when each pending fence was REQUESTED (injected clock;
        #: liveness-only): the ``fence_deadline_s`` bound reads these —
        #: a fence older than the deadline demotes to evict+resume
        self._fence_t: dict[str, float] = {}
        #: deadline-DEMOTED fences: uid → source host.  The evict drop
        #: was sent, but a checkpoint-boundary fence ack racing it must
        #: still commit the move (the boundary release is strictly
        #: better than the evict we fell back to); a true stale ack
        #: (coordinator restart) has no entry here and stays cursor-only
        self._fence_fallback: dict[str, str] = {}
        #: placement-skew hysteresis: host → when its skew alert was
        #: first seen holding (injected clock; liveness-only — the
        #: remediation DECISION journals, replay never reads a clock)
        self._remedy_hot: dict[str, float] = {}
        #: when the last remediation fired (the cooldown clock)
        self._remedy_last: float | None = None
        self.remedies = 0
        self.fences_timed_out = 0
        # -- gray-failure ladder state (all liveness-only EXCEPT the
        # probation set, which lives in journal.state.probation and
        # replays): host → when its gray_suspect alert was first seen
        # holding, probation host → when it was last seen CLEAN, host →
        # wall time of its last transcribed event (the append-age
        # signal's input), and the depth dial's burn timers
        self._gray_hot: dict[str, float] = {}
        self._gray_clean: dict[str, float] = {}
        self._gray_last_event_t: dict[str, float] = {}
        self._depth_burn: dict[str, float] = {}
        #: hosts currently dialed to cheap-stage scoring (subset of the
        #: probation set; liveness-only — the depth_change journals as a
        #: remedy audit record)
        self._depth_cheap: set = set()
        self.probations = 0
        self.gray_drains = 0
        self.depth_changes = 0
        #: the host currently draining (one scale-down at a time), and
        #: when the low-water mark started holding (injected clock;
        #: liveness-only — the drain DECISION journals, replay never
        #: reads a clock)
        self._draining_host: str | None = None
        self._low_since: float | None = None
        #: the one-shot latch of the operator ``--drain-host`` command
        self._operator_drained = False
        #: consecutive spawned hosts that died before their FIRST
        #: heartbeat — the autoscaler's crash-loop guard (any join
        #: resets it)
        self._stillborn = 0
        #: observed per-user finish-interval EMA (wall clock — the
        #: SLO-headroom scale-up signal's drain predictor; telemetry
        #: only, nothing journaled reads it)
        self._finish_ema: float | None = None
        self._last_finish_t: float | None = None
        #: the fabric-level planner (merged per-host sketches → one
        #: broadcast edge set); None unless the elastic plane is on
        self.fleet_planner: FleetPlanner | None = None
        if config.elastic and config.fleet_planner:
            self.fleet_planner = FleetPlanner(
                journal, epoch=config.planner_epoch,
                n_buckets=config.planner_buckets, report=self.report,
                tracer=tracer if introspect else None)
        # -- live intake (run(..., keep_open=True)): the producer
        # surface trace drivers submit through.  Ops append under the
        # lock from producer threads; _pump_intake drains them on the
        # coordinator thread, so every journal append stays
        # single-threaded (the single-writer discipline).
        self._intake: list = []
        self._intake_lock = threading.Lock()
        self._intake_open = False
        #: the close_intake latch: distinguishes "not open YET" (a
        #: producer that started before ``run`` — retryable, QueueFull)
        #: from "closed for good" (QueueClosed — stop submitting)
        self._intake_closed = False
        #: users a producer DISCONNECTED (evict sent, workspace kept at
        #: its last committed generation) awaiting reconnect — parked:
        #: still unresolved, but not re-routed until they return
        self._parked: set = set()
        #: disconnect evict-drops awaiting the owner's journaled ack —
        #: a reconnect must NOT re-route until the ack lands (the same
        #: exactly-one-owner discipline as migration: routing before the
        #: old owner provably released could run the user on two hosts)
        self._evict_pending: set = set()
        #: journaled-but-unrouted arrivals (routing deferred while an
        #: admission hold is active)
        self._unrouted: list = []
        self.disconnects = 0
        self.reconnects = 0
        # -- burn-rate admission hold (hold_on_burn): end-to-end
        # latency samples from transcribed admit→finish pairs feed the
        # slo_headroom burn detector; a sustained burn journals one
        # remedy record and defers routing.  All liveness-only state —
        # replay never reads it.
        self._admit_t: dict = {}
        self._lat: dict = collections.defaultdict(
            lambda: collections.deque(maxlen=HOLD_WINDOW))
        self._burn_hot: dict = {}
        self._hold_last: float | None = None
        self._hold_until: float | None = None
        self.holds = 0

    # -- lifecycle ---------------------------------------------------------

    def run(self, user_ids, spawn, *, classes: dict | None = None,
            pools: dict | None = None, keep_open: bool = False) -> dict:
        """Serve ``user_ids`` across the worker fleet; returns a summary
        dict.  ``spawn(host_id) -> Popen``-like launches one worker
        process (the CLI re-execs itself with ``--fabric-worker``; tests
        launch a synthetic-workload script) — the elastic autoscaler
        respawns replacements and scale-ups through the same callable.

        ``classes``: optional ``{user_id: priority_class}`` — carried on
        the journal's ``enqueue`` records and every assignment-feed line,
        so each worker's class-aware admission queue and per-class SLO
        histograms see the same classes the operator submitted; the
        journal's record wins for users it has already seen (restart /
        failover keeps first-submit classes).

        ``pools``: optional ``{user_id: enqueue-time pool size}`` —
        journaled on the ``enqueue`` records (exactly as the single-host
        server journals them), which is what makes BUCKET-AWARE
        placement a pure function of journal state: same-bucket users
        co-locate so stacked dispatches stay full per host.  Without
        pools, placement degrades to least-loaded.

        ``keep_open=True`` turns the run into a LIVE SERVICE: the fleet
        spawns even with zero initial users, producers feed it through
        :meth:`submit` / :meth:`disconnect` from other threads (the
        trace-driver surface), and the loop only exits once
        :meth:`close_intake` was called and everything resolved — the
        fabric sibling of ``FleetServer.serve(keep_open=True)``.

        Any escaping ``BaseException`` (injected coordinator kill,
        Ctrl-C) SIGKILLs every worker first — mirroring the orphan-exit
        the workers would perform themselves on a real coordinator death
        — and leaves all recovery state durable in the journal."""
        os.makedirs(self.fabric_dir, exist_ok=True)
        self._spawn_fn = spawn
        # claim this incarnation's fencing epoch FIRST — every feed line
        # and echoed ack below carries it.  A kill at the fault point
        # dies unclaimed; the restart re-derives the SAME number, which
        # is correct because no line stamped with it ever reached a
        # worker.  (A literal concurrent double-start on one filesystem
        # dies earlier still: the journal's flock raises
        # SingleWriterViolation on this very append.)
        faults.fire("fabric.epoch", epoch=self.epoch)
        self.journal.append("epoch", epoch=self.epoch)
        self.report.event("epoch_claim", epoch=self.epoch)
        # surface injected disk faults and quarantined records as fleet
        # events for the whole run (removed in the finally below)
        self._io_listener = lambda kind, path: self.report.event(
            "io_fault", kind=kind, path=path)
        dio.add_listener(self._io_listener)
        with self._intake_lock:  # a pre-run close_intake stays closed
            self._intake_open = keep_open and not self._intake_closed
        st = self.journal.state
        if st.last:
            self.report.event(
                "journal_recover", finished=len(st.finished),
                in_flight=len(st.in_flight), queued=len(st.queued),
                poisoned=len(st.poisoned))
        pending: list[str] = []
        classes = {str(u): c for u, c in (classes or {}).items()}
        pools = {str(u): int(p) for u, p in (pools or {}).items()}
        for u in st.recovery_order([str(u) for u in user_ids]):
            if u in st.finished:
                self.report.event("skip_done", user=u)
                continue
            if u in self.poison or u in st.poisoned:
                self.report.event("skip_poisoned", user=u)
                continue
            if st.last.get(u) in (None, "unpoison"):
                fields = {}
                cls = st.classes.get(u) or classes.get(u)
                if cls:
                    fields["cls"] = cls
                pool = st.pools.get(u) or pools.get(u)
                if pool:
                    fields["pool"] = int(pool)
                self.journal.append("enqueue", u, **fields)
            pending.append(u)
        self._submitted = list(pending)
        self._unresolved = set(pending)
        if self.config.elastic:
            # a drain the killed run never finished: its worker
            # orphan-exited with the coordinator, its shape record
            # already excludes it — journal the retirement so the ledger
            # closes and its users re-route below like everyone else's
            for hid in st.draining_hosts():
                rec = self.journal.append("drain_done", host=hid)
                self.report.event("drain_done", host=hid)
                self._ctl("ctl.drain_done", key=rec["seq"], host=hid,
                          startup=True)
        try:
            if pending or keep_open:  # a live service spawns up front
                for host_id in self._initial_fleet():
                    self._spawn_host(host_id, spawn)
                # (re)route every unresolved user AS ONE BATCH: prior-run
                # assignments are void (their processes were reaped
                # above), recovery_order already put in-flight users
                # ahead of the queue, and the batch planner folds each
                # placement into the next decision's load/bucket view so
                # same-bucket users co-locate with each other
                if pending:
                    self._route_batch(pending)
            while self._unresolved or self._intake_live():
                if self.preemption is not None \
                        and self.preemption.requested:
                    self._preempt_drain()
                self._pump_intake()
                for h in list(self.hosts.values()):
                    if h.alive:
                        self._transcribe(h)
                        self._transcribe_spans(h)
                self._check_hosts()
                self._pump_hold()
                if not self._unresolved and not self._intake_live():
                    break
                if self.config.elastic:
                    self._adopt_operator_hosts()
                    self._autoscale()
                    self._operator_drain()
                    self._scale_down()
                    self._pump_drain()
                    self._check_fence_deadlines()
                    self._pump_remedy()
                    self._pump_gray()
                    self._broadcast_edges()
                if not any(h.alive for h in self.hosts.values()):
                    # the elastic autoscaler above respawns dead capacity
                    # up to min_hosts; reaching here means it is off (or
                    # spawning itself failed and raised)
                    raise FabricError(
                        f"every worker host is down with "
                        f"{len(self._unresolved)} user(s) unresolved — "
                        "rerun the coordinator to recover from the "
                        "journal")
                if self.status is not None:
                    self.status.maybe_write(self._status_payload)
                if self.on_poll is not None:
                    self.on_poll(self)
                time.sleep(self.config.poll_s)
            self._close_hosts()
        except BaseException:
            self._kill_all()
            # an in-process "death" (InjectedKill drills) must also drop
            # the per-host channel handles — a real process death would
            # release their single-writer flocks, and the successor
            # incarnation reopens the same assign WALs
            self._release_channels()
            raise
        finally:
            dio.remove_listener(self._io_listener)
        return self._summary()

    # -- live intake (the trace-driver producer surface) -------------------

    def submit(self, user, *, cls: str | None = None,
               pool: int | None = None) -> None:
        """Thread-safe live submission (``run(..., keep_open=True)``):
        park one arrival in the bounded intake for the coordinator
        thread to journal and route on its next poll.  Raises
        ``QueueFull`` at ``intake_max`` (the producer must back off —
        the same backpressure contract as ``FleetServer.submit``) and
        ``QueueClosed`` once :meth:`close_intake` was called."""
        uid = str(user)
        with self._intake_lock:
            if self._intake_closed:
                raise QueueClosed(
                    "fabric intake is closed; stop submitting")
            if not self._intake_open:
                # the producer beat run() to its first event: the
                # intake opens on the coordinator thread — back off
                # exactly as at the bound
                raise QueueFull(
                    "fabric intake is not open yet (run(..., "
                    "keep_open=True) opens it); retry")
            if len(self._intake) >= self.config.intake_max:
                raise QueueFull(
                    f"fabric intake is at its bound "
                    f"({self.config.intake_max}); retry after the "
                    "coordinator pumps")
            self._intake.append(
                ("submit", uid, cls, int(pool) if pool else None))

    def disconnect(self, user) -> None:
        """Thread-safe live disconnect: the user's session is released
        at its next step boundary (workspace kept at its last committed
        generation) and the user PARKS — still journaled, still owed a
        result, but not scheduled — until a later :meth:`submit` of the
        same id reconnects it, resuming from the workspace (the journal
        re-admission path).  Users still away at :meth:`close_intake`
        are re-admitted automatically so the run drains to zero loss."""
        uid = str(user)
        with self._intake_lock:
            if self._intake_closed:
                raise QueueClosed("fabric intake is closed")
            if not self._intake_open:
                raise QueueFull("fabric intake is not open yet; retry")
            self._intake.append(("disconnect", uid))

    def close_intake(self) -> None:
        """No further submissions; the run exits once every accepted
        user resolves.  Idempotent, callable from any thread."""
        with self._intake_lock:
            self._intake_open = False
            self._intake_closed = True

    def _intake_live(self) -> bool:
        with self._intake_lock:
            return self._intake_open or bool(self._intake)

    def _pump_intake(self) -> None:
        """Drain the producer intake on the coordinator thread: journal
        fresh arrivals (the journal's record wins for users it has seen
        — restart keeps first-submit classes), unpark reconnects, apply
        disconnects, then route the round AS ONE BATCH — deferred to
        ``_unrouted`` while an admission hold is active."""
        with self._intake_lock:
            ops, self._intake = self._intake, []
            open_ = self._intake_open
        if not ops and not (not open_ and self._parked):
            return
        st = self.journal.state
        fresh: list = []
        for op in ops:
            if op[0] == "disconnect":
                self._disconnect(op[1])
                continue
            _, u, cls, pool = op
            if u in st.finished:
                self.report.event("skip_done", user=u)
                continue
            if u in self.poison or u in st.poisoned:
                self.report.event("skip_poisoned", user=u)
                continue
            if u in self._parked:
                # the reconnect: resume scheduling from the workspace.
                # Routing waits for a still-pending evict ack (the
                # exactly-one-owner discipline) — the ack handler
                # routes the moment the old owner provably released.
                self._parked.discard(u)
                self.reconnects += 1
                self.report.event("reconnect", user=u)
                if u not in self._evict_pending:
                    fresh.append(u)
                continue
            if u in self._unresolved:
                continue  # duplicate submit: already live
            if st.last.get(u) in (None, "unpoison"):
                fields = {}
                c = st.classes.get(u) or cls
                if c:
                    fields["cls"] = c
                p = st.pools.get(u) or pool
                if p:
                    fields["pool"] = int(p)
                self.journal.append("enqueue", u, **fields)
                self.report.event("enqueue", user=u,
                                  depth=len(self._unresolved) + 1)
            self._submitted.append(u)
            self._unresolved.add(u)
            fresh.append(u)
        if not open_ and self._parked:
            # intake closed with users still away: no reconnect is
            # coming — re-admit them so their journaled work finishes
            # (the zero-loss drain; a real service would expire them)
            for u in sorted(self._parked):
                self.report.event("reconnect", user=u, forced=True)
                if u not in self._evict_pending:
                    fresh.append(u)
            self._parked.clear()
        fresh = [u for u in fresh if u in self._unresolved]
        if not fresh:
            return
        if self._hold_until is not None:
            self._unrouted.extend(fresh)
        else:
            self._route_batch(fresh)

    def _disconnect(self, u: str) -> None:
        """Apply one disconnect on the coordinator thread: park the
        user and ask its owner to release at the next step boundary
        (the evict drop — acked, so a reconnect can never race the
        release into two owners).  A user mid-migration/fence keeps its
        in-flight verb — one ack-gated verb at a time."""
        if u not in self._unresolved or u in self._parked:
            return  # unknown, resolved, or already away
        if u in self._migrating or u in self._fencing:
            return  # its current verb's ack supersedes; nothing to park
        self._parked.add(u)
        self.disconnects += 1
        self.report.event("disconnect", user=u)
        hid = self.journal.state.assigned.get(u)
        h = self.hosts.get(hid) if hid is not None else None
        if h is not None and h.alive:
            self._evict_pending.add(u)
            h.assign.append({"drop": u, "evict": True})

    # -- burn-rate admission hold (hold_on_burn) ---------------------------

    def _class_p95s(self) -> dict:
        """Observed end-to-end p95 per class over the rolling latency
        window (transcribed admit→finish pairs)."""
        out = {}
        for cls, dq in self._lat.items():
            if dq:
                xs = sorted(dq)
                out[cls] = xs[min(len(xs) - 1,
                                  max(0, int(0.95 * len(xs))))]
        return out

    def _pump_hold(self) -> None:
        """One burn-detector round (``hold_on_burn``): when a class's
        observed p95 has burned past ``BURN_FRAC`` of its SLO target
        CONTINUOUSLY for ``remedy_hold_s`` (same hysteresis kernel as
        the skew remedy) and the cooldown elapsed, journal one
        ``remedy`` record (action ``admission_hold``; the
        ``fabric.remedy`` fault point fires first — a kill leaves no
        record and the restart re-times the burn) and DEFER ROUTING of
        new arrivals for ``admission_hold_s``.  Arrivals stay journaled
        (durability is never deferred); only placement waits.  Acting
        REARMS the watcher's ``slo_headroom`` key so a re-risen burn
        fires a fresh alert event."""
        from consensus_entropy_tpu_torch.obs import alerts as alerts_mod

        cfg = self.config
        if not cfg.hold_on_burn:
            return
        now = self._clock()
        if self._hold_until is not None and now >= self._hold_until:
            self._hold_until = None
            if self._unrouted:
                batch = [u for u in self._unrouted
                         if u in self._unresolved
                         and u not in self._parked]
                self._unrouted = []
                if batch:
                    self._route_batch(batch)
        slo = {"interactive": cfg.slo_interactive_s,
               "batch": cfg.slo_batch_s}
        burning = {a["cls"] for a in alerts_mod.slo_headroom_alerts(
            self._class_p95s(), slo)}
        for cls in list(self._burn_hot):
            if cls not in burning:
                del self._burn_hot[cls]  # burn cleared: re-time
        for cls in sorted(burning):
            self._burn_hot.setdefault(cls, now)
        if self._hold_until is not None:
            return  # one hold at a time
        if not remedy_mod.cooldown_ok(self._hold_last, now,
                                      cooldown_s=cfg.remedy_cooldown_s):
            return
        due = sorted(cls for cls, t0 in self._burn_hot.items()
                     if remedy_mod.remedy_due(t0, now,
                                              hold_s=cfg.remedy_hold_s))
        if not due:
            return
        cls = due[0]
        # a kill here models dying between the hold decision and its
        # journal record: nothing was deferred (arrivals are journaled
        # either way), the restart re-times the burn — dispositions
        # replay identically because a remedy record is audit-only
        faults.fire("fabric.remedy", host="fleet", action="admission_hold")
        rec = self.journal.append("remedy", host="fleet",
                                  action="admission_hold", cls=cls,
                                  hold_s=float(cfg.admission_hold_s))
        self.holds += 1
        self._hold_last = now
        self._hold_until = now + cfg.admission_hold_s
        self._burn_hot.pop(cls, None)
        self.report.event("admission_hold",
                          window_s=float(cfg.admission_hold_s), cls=cls)
        self._ctl("ctl.remedy", key=rec["seq"], host="fleet",
                  action="admission_hold", cls=cls)
        if self.alerts is not None:
            # acting on the alert CONSUMES it (the rearm discipline)
            self.alerts.rearm("slo_headroom", cls)

    def _initial_fleet(self) -> list:
        """The host ids this run stands up.  Elastic restarts replay the
        journaled fleet SHAPE — every host whose last membership record
        is not a revoke, clamped to ``max_hosts`` — so a coordinator
        SIGKILL + rerun rebuilds the exact fleet the autoscaler had
        grown (the replay-determinism contract).  Fresh runs (and the
        non-elastic fabric, always) spawn ``h0..h{hosts-1}``."""
        if self.config.elastic:
            shape = self.journal.state.fleet_hosts()
            if shape:
                # numeric order (h2 before h10), so the max_hosts clamp
                # keeps the lowest-numbered ids — the ones next_host_id
                # will never hand out again
                def _num(hid):
                    m = re.match(r"^h(\d+)$", hid)
                    return (0, int(m.group(1))) if m else (1, 0)

                return sorted(shape, key=lambda h: (_num(h), h)) \
                    [: self.config.max_hosts]
        return [f"h{i}" for i in range(self.config.hosts)]

    # -- host management ---------------------------------------------------

    def _spawn_host(self, host_id: str, spawn) -> HostHandle:
        paths = fabric_paths(self.fabric_dir, host_id)
        self._reap_stale(host_id, paths)
        proc = spawn(host_id)
        h = self._register_host(host_id, proc, paths)
        self.report.event("host_up", host=host_id,
                          pid=getattr(proc, "pid", None))
        return h

    def _register_host(self, host_id: str, proc, paths: dict) -> HostHandle:
        """The shared handle wiring for spawned AND adopted hosts: event
        tail resumed at the journaled cursor, lease membership journaled,
        assign channel opened."""
        tail = JsonlTail(paths["events"])
        tail.seek(self.journal.state.host_cursor.get(host_id, 0))
        self.journal.append("lease", host=host_id,
                            pid=getattr(proc, "pid", None))
        h = HostHandle(host_id, proc,
                       _EpochFeed(_AppendFsyncFile(paths["assign"]),
                                  self.epoch),
                       tail, paths["lease"], self._clock())
        if self.tracer is not None and self.tracer.enabled:
            h.span_tail = JsonlTail(paths["spans"])
        self.hosts[host_id] = h
        return h

    def _pid_is_fabric_worker(self, pid: int) -> bool:
        """The lease file's pid may have been RECYCLED to an unrelated
        process since the worker died — only kill a process whose
        command line actually names this fabric's directory (every
        worker carries it in argv).  No ``/proc`` entry (process gone,
        or a platform without procfs) → nothing safe to reap."""
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().decode("utf-8", "replace")
        except OSError:
            return False
        return self.fabric_dir in cmd

    def _reap_stale(self, host_id: str, paths: dict) -> None:
        """Kill any orphan worker a crashed coordinator left behind (its
        lease file names the pid) and clear the stale channels, so the
        fresh worker never races an orphan for the same workspaces.  The
        events file is KEPT — its transcription cursor lives in the
        journal and must stay valid."""
        lease = read_lease(paths["lease"])
        pid = lease.get("pid") if lease else None
        if isinstance(pid, int) and pid != os.getpid() \
                and self._pid_is_fabric_worker(pid):
            try:
                os.kill(pid, signal.SIGKILL)
                self.report.event("orphan_reaped", host=host_id, pid=pid)
            except (ProcessLookupError, PermissionError):
                pass
            else:
                deadline = self._clock() + 5.0
                while self._clock() < deadline:
                    try:
                        os.kill(pid, 0)
                    except (ProcessLookupError, PermissionError):
                        break
                    time.sleep(0.02)
        for key in ("lease", "assign"):
            try:
                os.remove(paths[key])
            except FileNotFoundError:
                pass

    def _check_hosts(self) -> None:
        now = self._clock()
        for h in list(self.hosts.values()):
            if not h.alive:
                continue
            rc = h.proc.poll()
            if rc is not None:
                if h.draining:
                    # a draining worker EXITS ON ITS OWN once its intake
                    # is closed and its last session finished or
                    # released — that is the clean retirement, not a
                    # death.  Only a drain that still holds unresolved
                    # users (it died mid-shed) fails over.
                    self._transcribe(h)
                    self._transcribe_spans(h)
                    if not any(u in self._unresolved for u in
                               self.journal.state.assigned_to(h.host_id)):
                        self._finish_drain(h)
                        continue
                self._fail_over(h, f"worker exited rc={rc}")
                continue
            age = lease_age_s(h.lease_path, now)
            if age is None:
                if now - h.spawned_t > self.config.spawn_grace_s:
                    self._fail_over(h, "no first heartbeat within "
                                       "spawn grace")
            elif age > self.config.lease_s:
                self._fail_over(h, f"lease expired ({age:.1f}s since "
                                   "last heartbeat)")
            elif not h.joined:
                self._join(h)

    def _join(self, h: HostHandle) -> None:
        """First heartbeat observed: the host is UP.  Under the elastic
        plane the JOIN is journaled (the replayable fleet shape), the
        fleet planner's current edges are pushed so the joiner routes
        like everyone else, and queued users REBALANCE onto it — the
        capacity a fresh host brings must actually absorb load, not sit
        idle behind assignments made before it existed."""
        h.joined = True
        self._stillborn = 0  # spawning demonstrably works again
        beat = read_lease(h.lease_path)
        if beat is not None and isinstance(beat.get("devices"), int):
            # chips-per-host heterogeneity: advertised in the heartbeat
            # (same channel liveness itself rides), read once at JOIN —
            # placement then routes wide-pool buckets toward this host
            h.devices = beat["devices"]
        if not self.config.elastic:
            return  # static fleet: membership is lease-only
        self.joins += 1
        rec = self.journal.append("join", host=h.host_id,
                                  devices=h.devices)
        self.report.event("host_join", host=h.host_id)
        self._ctl("ctl.join", key=rec["seq"], host=h.host_id)
        if self.fleet_planner is not None and self.fleet_planner.edges:
            h.assign.append({"edges": list(self.fleet_planner.edges)})
        # users STRANDED on a host that died while no live target
        # existed (every worker down in one failover window): their
        # re-route was deferred — the joiner is the first live target,
        # so batch-place them now, in-flight first
        stranded = [u for u in self.journal.state.pending
                    if u in self._unresolved
                    and not self._host_is_live(
                        self.journal.state.assigned.get(u))]
        if stranded:
            self._route_batch(stranded)
            self.reassignments += len(stranded)
        self._rebalance(h)

    def _rebalance(self, new: HostHandle) -> None:
        """Migrate queued (never in-flight) users onto a joined host.

        The PLAN is a pure function of journaled state
        (``placement.plan_rebalance``); the hand-off is two-phase: the
        source worker gets a ``drop`` line on its assignment feed, and
        only its journaled ACK (the user was still queued there) commits
        the move — a user the worker admitted in the meantime refuses
        the drop and stays, so no user can ever run on two hosts.  A
        coordinator kill mid-rebalance is safe at every point: un-acked
        users keep their journaled assignment, acked-and-reassigned
        users carry the new one, and the restart re-derives placement
        from the journal alone."""
        st = self.journal.state
        queued_by_host: dict[str, list] = {}
        for u in st.queued:
            if u not in self._unresolved or u in self._migrating:
                continue
            src = st.assigned.get(u)
            if src is None or src == new.host_id:
                continue
            sh = self.hosts.get(src)
            if sh is None or not sh.alive:
                continue
            queued_by_host.setdefault(src, []).append(u)
        loads = {hh.host_id: self._load_of(hh.host_id)
                 for hh in self.hosts.values() if hh.alive}
        moves = placement_mod.plan_rebalance(
            new.host_id, loads=loads, queued_by_host=queued_by_host)
        for u, src in moves:
            self._migrating[u] = new.host_id
            self.hosts[src].assign.append({"drop": u})
            self.report.event("migrate_request", user=u,
                              host=new.host_id)

    def _autoscale(self) -> None:
        """One autoscaler decision round: respawn dead capacity below
        ``min_hosts`` and scale up on the queue-depth / SLO-headroom
        signals, one journaled ``spawn`` per new host so a restarted
        coordinator replays the identical fleet shape."""
        cfg = self.config
        if self._spawn_fn is None:
            return
        if self._stillborn >= 3:
            # crash-loop guard: respawning cannot out-run a worker that
            # dies before its first heartbeat every time (bad argv,
            # missing dep, OOM at import) — without this the elastic
            # fabric would fork-storm at poll rate forever where the
            # non-elastic fabric raises FabricError.  All state is
            # durable: fix the worker and rerun the coordinator.
            raise FabricError(
                f"{self._stillborn} consecutive worker(s) died before "
                "their first heartbeat — the spawn path looks broken; "
                "rerun the coordinator to recover from the journal")
        live = sum(1 for h in self.hosts.values() if h.alive)
        queued = sum(1 for u in self.journal.state.queued
                     if u in self._unresolved)
        target = target_hosts(
            live=live, queued=queued, min_hosts=cfg.min_hosts,
            max_hosts=cfg.max_hosts, scale_backlog=cfg.scale_backlog,
            scale_slo_s=cfg.scale_slo_s, finish_ema_s=self._finish_ema)
        while live < target:
            hid = next_host_id(set(self.hosts)
                               | set(self.journal.state.hosts))
            reason = "replace" if live < cfg.min_hosts else "scale_up"
            # a kill here models dying between the scale decision and
            # its journal record: nothing was spawned, the restart
            # re-decides from the same journaled state
            faults.fire("fabric.spawn", host=hid, reason=reason)
            rec = self.journal.append("spawn", host=hid, reason=reason)
            self.spawns += 1
            self._spawn_host(hid, self._spawn_fn)
            self.report.event("host_spawn", host=hid, reason=reason)
            self._ctl("ctl.spawn", key=rec["seq"], host=hid,
                      reason=reason)
            live += 1

    def _scale_down(self) -> None:
        """One scale-down decision round: once the low-water mark
        (``elastic.scale_down_ok`` — both scale-up signals quiet at
        ``live - 1``) has held for ``scale_down_s`` CONTINUOUS seconds
        and the fleet sits above ``min_hosts``, drain one surplus host:
        journal the decision (``drain`` — the ``fabric.drain`` fault
        point fires first, so a kill leaves no record and the restart
        re-times the mark), send the drain sentinel, and let
        :meth:`_pump_drain` shed its users.  One drain at a time: the
        next candidate is only timed once the current host retired."""
        cfg = self.config
        if not cfg.scale_down_s:
            return
        if self._draining_host is not None:
            self._low_since = None
            return
        candidates = {h.host_id: self._load_of(h.host_id)
                      for h in self.hosts.values()
                      if h.alive and h.joined and not h.draining}
        queued = sum(1 for u in self.journal.state.queued
                     if u in self._unresolved)
        if not scale_down_ok(live=len(candidates), queued=queued,
                             min_hosts=cfg.min_hosts,
                             scale_backlog=cfg.scale_backlog,
                             scale_slo_s=cfg.scale_slo_s,
                             finish_ema_s=self._finish_ema):
            self._low_since = None
            return
        now = self._clock()
        if self._low_since is None:
            self._low_since = now
            return
        if now - self._low_since < cfg.scale_down_s:
            return
        victim = drain_victim(candidates)
        self._start_drain(victim, "scale_down", candidates[victim])

    def _start_drain(self, victim: str, reason: str, load: int) -> None:
        """Journal one drain decision and send the sentinel — shared by
        the autoscaler's low-water path and the operator's
        ``--drain-host`` command (same record, same fault point, same
        replay semantics)."""
        h = self.hosts[victim]
        # a kill here models dying between the scale-down decision and
        # its journal record: nothing drained, the restart re-derives
        # the same fleet and re-times the low-water mark
        faults.fire("fabric.drain", host=victim)
        rec = self.journal.append("drain", host=victim)
        self.drains += 1
        self._draining_host = victim
        self._low_since = None
        h.draining = True
        h.assign.append({"drain": True})
        self.report.event("host_drain", host=victim, load=load,
                          reason=reason)
        self._ctl("ctl.drain", key=rec["seq"], host=victim,
                  reason=reason, load=load)

    def _operator_drain(self) -> None:
        """The ``--drain-host`` command: drain
        the named host through the scale-down machinery the moment it is
        live and joined — one shot per run, deferred while another drain
        is in progress.  A restarted coordinator whose journal already
        shows the host shed (drained, retired or revoked) does NOT
        re-drain a replacement that happens to reuse the name: the
        command is about the journaled host, and its disposition is
        durable."""
        hid = self.config.drain_host
        if hid is None or self._operator_drained:
            return
        if self.journal.state.hosts.get(hid) in ("drain", "drain_done",
                                                 "revoke"):
            self._operator_drained = True
            return
        if self._draining_host is not None:
            return  # one drain at a time; retry next poll
        h = self.hosts.get(hid)
        if h is None or not h.alive or not h.joined or h.draining:
            return  # not up yet: retry next poll
        self._operator_drained = True
        self._start_drain(hid, "operator", self._load_of(hid))

    def _pump_drain(self) -> None:
        """One shed round for the draining host: withdraw its queued
        users over the existing drop-ack path (placement picks each
        target among the non-draining survivors), FENCE its in-flight
        users (``migrate_inflight``; off = drain-by-waiting, they just
        finish), and retire the host once the journal shows it holds
        nothing unresolved.  Requests are idempotent per user — a
        pending drop/fence is never re-sent, and a refused one
        re-derives from the user's post-refusal disposition (a
        drop-refused user shows ``admit`` next round and is fenced)."""
        hid = self._draining_host
        if hid is None:
            return
        h = self.hosts.get(hid)
        if h is None or not h.alive:
            self._draining_host = None  # failover superseded the drain
            return
        st = self.journal.state
        mine = [u for u in st.assigned_to(hid) if u in self._unresolved]
        if not mine:
            self._finish_drain(h)
            return
        targets = self._route_targets()
        if not targets:
            return  # nowhere to shed yet; the autoscaler may add capacity
        queued = set(st.queued)
        fresh = [u for u in mine
                 if u not in self._migrating and u not in self._fencing]
        # the round's queued withdrawals place as ONE batch plan — the
        # same anti-herding view _fail_over uses: per-user place_user
        # against this round's static journal view would send every
        # queued user to the same least-loaded survivor
        drop_target = dict(placement_mod.plan_failover(
            [u for u in fresh if u in queued], state=st,
            unresolved=self._unresolved, hosts=targets,
            edges=self._fleet_edges(), policy=self.config.placement,
            devices=self._host_devices()))
        for u in fresh:
            if u in queued:
                target = drop_target[u]
                self._migrating[u] = target
                h.assign.append({"drop": u})
                self.report.event("migrate_request", user=u, host=target)
            elif self.config.migrate_inflight \
                    and st.last.get(u) == "admit":
                # genuinely admitted: request the checkpoint-fenced
                # release.  A backoff-failed user (last event ``fail``)
                # is skipped — it re-enqueues itself when its delay
                # elapses and then takes the drop path above
                self._fencing[u] = hid
                self._fence_t[u] = self._clock()
                h.assign.append({"fence": u})
                self.report.event("migrate_request", user=u, host=hid)

    def _finish_drain(self, h: HostHandle) -> None:
        """The draining host resolved everything it held: retire it.
        The worker's serve loop exits on its own (intake closed, nothing
        queued or in-flight); send the close sentinel in case it is
        still mid-exit, give it ``drain_timeout_s``, SIGKILL a straggler
        (nothing left to lose — every disposition is journaled), drain
        its final events, and journal ``drain_done`` — the lease
        retirement that takes it out of the replayed fleet shape."""
        h.alive = False
        h.closed = True
        if h.proc.poll() is None:
            try:
                h.assign.append({"close": True})
            except Exception:
                pass
            deadline = self._clock() + self.config.drain_timeout_s
            while h.proc.poll() is None and self._clock() < deadline:
                time.sleep(self.config.poll_s)
            if h.proc.poll() is None:
                self.report.event("drain_kill", host=h.host_id)
                try:
                    h.proc.kill()
                    h.proc.wait(timeout=10)
                except Exception:
                    pass
        self._transcribe(h)
        self._transcribe_spans(h)
        rec = self.journal.append("drain_done", host=h.host_id)
        self.report.event("drain_done", host=h.host_id)
        self._ctl("ctl.drain_done", key=rec["seq"], host=h.host_id)
        if h.host_id == self._draining_host:
            self._draining_host = None

    def _check_fence_deadlines(self) -> None:
        """DEADLINE-FENCED degradation (``fence_deadline_s``): a pending
        checkpoint fence the source host has not acked within the
        deadline demotes to evict+resume — journal the timeout
        (``remedy`` record, action ``fence_timeout``; the
        ``fabric.remedy`` fault point fires first, so a kill leaves no
        record and the restart re-routes from the journal alone), move
        the fence to the fallback set, pick the resume target NOW (the
        evict drop ack commits it), and send the evict.  The session
        releases at its next STEP boundary — any step, not the iteration
        checkpoint — so no fence stays open longer than the deadline
        plus one poll interval.  A checkpoint ack racing the evict still
        commits via the fallback set (:meth:`_transcribe`)."""
        cfg = self.config
        if not cfg.fence_deadline_s or not self._fencing:
            return
        now = self._clock()
        for u in list(self._fencing):
            if u not in self._unresolved:
                continue  # its resolution ack is in flight; let it land
            if not remedy_mod.fence_expired(
                    self._fence_t.get(u), now,
                    deadline_s=cfg.fence_deadline_s):
                continue
            src = self._fencing[u]
            sh = self.hosts.get(src)
            if sh is None or not sh.alive:
                continue  # failover supersedes (it pops the fence)
            targets = [t for t in self._route_targets() if t != src]
            if not targets:
                continue  # nowhere to resume yet; keep waiting
            # a kill here models dying between the timeout decision and
            # its journal record: the fence stays pending in no one's
            # memory — the restart re-places the user from the journal
            faults.fire("fabric.remedy", user=u, host=src,
                        action="fence_timeout")
            rec = self.journal.append("remedy", u, host=src,
                                      action="fence_timeout")
            self.fences_timed_out += 1
            self.report.event("fence_timeout", user=u, host=src)
            self._ctl("ctl.remedy", key=rec["seq"], host=src,
                      action="fence_timeout", user=u, flow_user=u)
            del self._fencing[u]
            self._fence_t.pop(u, None)
            self._fence_fallback[u] = src
            target = placement_mod.place_user(
                u, state=self.journal.state,
                unresolved=self._unresolved, hosts=targets,
                edges=self._fleet_edges(), policy=cfg.placement,
                devices=self._host_devices())
            self._migrating[u] = target
            sh.assign.append({"drop": u, "evict": True})
            self.report.event("migrate_request", user=u, host=target)

    def _evaluate_alerts(self) -> list:
        """The coordinator's COMPOSED alert list — every kind this
        process watches (lease burn + placement skew) in one list,
        because ``AlertWatcher.update`` is snapshot-based: two call
        sites feeding partial lists would delete each other's active
        keys."""
        from consensus_entropy_tpu_torch.obs import alerts as alerts_mod

        now = self._clock()
        lease_ages = {hid: lease_age_s(h.lease_path, now)
                      for hid, h in self.hosts.items()
                      if h.alive and h.joined}
        out = alerts_mod.lease_alerts(lease_ages, self.config.lease_s)
        out += alerts_mod.skew_alerts(
            self._live_loads(), max_skew=self.config.remedy_skew)
        if self.config.hold_on_burn:
            # the burn detector's view rides the SAME composed list (the
            # snapshot-based watcher would otherwise drop these keys)
            out += alerts_mod.slo_headroom_alerts(
                self._class_p95s(),
                {"interactive": self.config.slo_interactive_s,
                 "batch": self.config.slo_batch_s})
        if self.config.gray:
            # the gray detector rides the composed list too — the
            # ladder pump reads the same kernels directly for its
            # hysteresis, the watcher only edge-triggers the event
            out += self._gray_alerts(now)
        return out

    def _live_loads(self) -> dict:
        """Unresolved-user load per live, joined, non-draining host —
        the skew kernel's input (journal-replayed, same view placement
        places by)."""
        return {h.host_id: self._load_of(h.host_id)
                for h in self.hosts.values()
                if h.alive and h.joined and not h.draining}

    def _pump_remedy(self) -> None:
        """One remediation round (``remedy``): when a live host's
        placement-skew alert has held CONTINUOUSLY for ``remedy_hold_s``
        (and the fleet-wide cooldown elapsed), journal one ``remedy``
        decision (the ``fabric.remedy`` fault point fires first) and
        DRAIN-FOR-REBALANCE the host: shed exactly ``shed_count`` users
        — ``load - floor - max_skew``, which lands the host AT the
        highest non-alerting load, so the remediation can never flap —
        queued users over the drop-ack path, in-flight users (newest
        admissions first — most sunk work sheds last) via checkpoint
        fences.  The host is NOT retired: no drain record, no sentinel,
        it keeps admitting.  Gated off while any migration, fence or
        drain is in flight — one ack-gated wave at a time keeps replay
        auditable.  After acting, the watcher's skew alert REARMS so a
        re-risen condition fires a second ``alert`` event (the
        edge-trigger bugfix this PR pins)."""
        from consensus_entropy_tpu_torch.obs import alerts as alerts_mod

        cfg = self.config
        if not cfg.remedy:
            return
        if self.alerts is not None:
            # the remediation plane evaluates every poll; feed the
            # watcher the same COMPOSED list _status_payload does so
            # the two sites never delete each other's active keys
            self.alerts.update(self._evaluate_alerts())
        if self._migrating or self._fencing or self._draining_host:
            return
        loads = self._live_loads()
        now = self._clock()
        hot = {a["host"] for a in alerts_mod.skew_alerts(
            loads, max_skew=cfg.remedy_skew)}
        for hid in list(self._remedy_hot):
            if hid not in hot:
                del self._remedy_hot[hid]  # condition cleared: re-time
        for hid in sorted(hot):
            self._remedy_hot.setdefault(hid, now)
        if not remedy_mod.cooldown_ok(self._remedy_last, now,
                                      cooldown_s=cfg.remedy_cooldown_s):
            return
        due = [hid for hid, t0 in self._remedy_hot.items()
               if remedy_mod.remedy_due(t0, now,
                                        hold_s=cfg.remedy_hold_s)]
        if not due:
            return
        # worst offender first; host-id tie-break keeps the pick stable
        victim = max(due, key=lambda hid: (loads.get(hid, 0), hid))
        h = self.hosts.get(victim)
        if h is None or not h.alive or h.draining:
            self._remedy_hot.pop(victim, None)
            return
        targets = [t for t in self._route_targets() if t != victim]
        if not targets:
            return  # nowhere to shed; the autoscaler may add capacity
        st = self.journal.state
        count = remedy_mod.shed_count(
            loads[victim], min(loads.values()), max_skew=cfg.remedy_skew)
        mine = [u for u in st.assigned_to(victim)
                if u in self._unresolved]
        queued = [u for u in mine if st.last.get(u) == "enqueue"]
        in_flight = [u for u in mine if st.last.get(u) == "admit"]
        drops, fences = remedy_mod.pick_shed(
            queued, in_flight, count,
            migrate_inflight=cfg.migrate_inflight)
        if not drops and not fences:
            return
        # a kill here models dying between the remediation decision and
        # its journal record: nothing moved, no request sent — the
        # restart re-detects the (journal-derived) skew, re-times the
        # hold, and re-derives the identical shed; every move below is
        # ack-gated, so no user is ever double-moved either way
        faults.fire("fabric.remedy", host=victim, action="rebalance")
        rec = self.journal.append("remedy", host=victim,
                                  action="rebalance")
        self.remedies += 1
        self._remedy_last = now
        self._remedy_hot.pop(victim, None)
        self.report.event("remedy", host=victim, action="rebalance")
        self._ctl("ctl.remedy", key=rec["seq"], host=victim,
                  action="rebalance", drops=len(drops),
                  fences=len(fences))
        # the round's withdrawals place as ONE batch plan (the
        # _pump_drain anti-herding discipline)
        drop_target = dict(placement_mod.plan_failover(
            drops, state=st, unresolved=self._unresolved, hosts=targets,
            edges=self._fleet_edges(), policy=cfg.placement,
            devices=self._host_devices()))
        for u in drops:
            self._migrating[u] = drop_target[u]
            h.assign.append({"drop": u})
            self.report.event("migrate_request", user=u,
                              host=drop_target[u])
        for u in fences:
            self._fencing[u] = victim
            self._fence_t[u] = now
            h.assign.append({"fence": u})
            self.report.event("migrate_request", user=u, host=victim)
        if self.alerts is not None:
            # acting on the alert CONSUMES it: the next evaluation
            # re-fires if the condition still (or again) holds
            self.alerts.rearm("placement_skew", victim)

    def _gray_alerts(self, now: float) -> list:
        """Assemble the four peer-relative gray signals from state the
        coordinator already watches and run the detector
        (``obs.alerts.gray_suspect_alerts``):

        - append age: seconds since each LOADED host's event journal
          last yielded a transcription (idle hosts excluded — they
          legitimately append nothing; a loaded host that has not yet
          transcribed its FIRST event is unobserved rather than aged,
          so a cold worker still compiling is never accused of going
          quiet before it ever spoke);
        - ack lag: age of each host's oldest pending checkpoint fence
          (``0.0`` for hosts with nothing pending, so only a genuinely
          lagging source skews);
        - lease age: the same injected-clock view ``lease_alerts``
          reads — gray catches beats that land LATE without expiring;
        - step wall: the worker's self-advertised dispatch EMA
          (``step_ema_s`` on its lease record)."""
        from consensus_entropy_tpu_torch.obs import alerts as alerts_mod

        cfg = self.config
        append_ages: dict = {}
        ack_lags: dict = {}
        lease_ages: dict = {}
        step_walls: dict = {}
        for hid, h in self.hosts.items():
            if not (h.alive and h.joined):
                continue
            lease_ages[hid] = lease_age_s(h.lease_path, now)
            if self._load_of(hid) > 0:
                t0 = self._gray_last_event_t.get(hid)
                append_ages[hid] = None if t0 is None \
                    else max(now - t0, 0.0)
            beat = read_lease(h.lease_path)
            step = (beat or {}).get("step_ema_s")
            step_walls[hid] = float(step) \
                if isinstance(step, (int, float)) else None
            ack_lags[hid] = 0.0
        for u, src in self._fencing.items():
            t0 = self._fence_t.get(u)
            if src in ack_lags and t0 is not None:
                ack_lags[src] = max(ack_lags[src], now - t0)
        return alerts_mod.gray_suspect_alerts(
            append_ages=append_ages, ack_lags=ack_lags,
            lease_ages=lease_ages, step_walls=step_walls,
            ratio=cfg.gray_ratio, min_abs_s=cfg.gray_min_s)

    def _pump_gray(self) -> None:
        """One gray-ladder round (``gray``): fold each host's
        gray_suspect evidence into the hysteresis timers and walk the
        ladder — sustained suspicion journals PROBATION (placement
        stops routing NEW users; the record REPLAYS, so a coordinator
        SIGKILL mid-ladder restarts at the same rung), more of the same
        drains the host's existing users over the drain-for-rebalance
        machinery (``remedy`` record, action ``gray_drain``; every move
        ack-gated), and a sustained clean streak lifts probation.  The
        deadline-fenced EVICT beyond drain is not driven here — it is
        ``_check_fence_deadlines`` firing on the drain's own fences."""
        cfg = self.config
        if not cfg.gray:
            return
        if self.alerts is not None:
            # feed the watcher the same COMPOSED list every other call
            # site does (snapshot-based: partial lists delete keys)
            self.alerts.update(self._evaluate_alerts())
        now = self._clock()
        st = self.journal.state
        suspects = {a["host"]: a for a in self._gray_alerts(now)}
        for hid in list(self._gray_hot):
            if hid not in suspects:
                del self._gray_hot[hid]  # condition cleared: re-time
        for hid in sorted(suspects):
            self._gray_hot.setdefault(hid, now)
        for hid in list(self._gray_clean):
            if hid in suspects or hid not in st.probation:
                del self._gray_clean[hid]
        for hid in sorted(st.probation):
            if hid not in suspects:
                self._gray_clean.setdefault(hid, now)
        # the DOWN ladder first: a host that earned its lift is a route
        # target again before this round's escalations place anything
        for hid in sorted(st.probation):
            if not remedy_mod.probation_clear(
                    self._gray_clean.get(hid), now,
                    clear_s=cfg.gray_clear_s):
                continue
            faults.fire("fabric.gray", host=hid, rung="lift")
            rec = self.journal.append("probation", host=hid, on=False)
            self.report.event("probation", host=hid, on=False)
            self._ctl("ctl.gray", key=rec["seq"], host=hid,
                      rung="healthy")
            self._gray_clean.pop(hid, None)
            self._restore_depth(hid)
        self._pump_depth(now)
        for hid in sorted(suspects):
            h = self.hosts.get(hid)
            if h is None or not h.alive or h.draining:
                continue
            rung = remedy_mod.gray_rung(
                self._gray_hot.get(hid), now,
                hold_s=cfg.gray_hold_s, drain_s=cfg.gray_drain_s)
            if rung in ("probation", "drain") \
                    and hid not in st.probation:
                # a kill here models dying between the rung decision
                # and its journal record: nothing routed differently
                # yet — the restart re-times the evidence and re-derives
                # the same escalation from the journal alone
                faults.fire("fabric.gray", host=hid, rung="probation")
                rec = self.journal.append("probation", host=hid,
                                          on=True)
                self.probations += 1
                self.report.event("probation", host=hid, on=True)
                self._ctl("ctl.gray", key=rec["seq"], host=hid,
                          rung="probation")
                if self.alerts is not None:
                    # acting on the alert CONSUMES it (rearm discipline)
                    self.alerts.rearm("gray_suspect", hid)
            if rung == "drain":
                self._gray_drain(hid, now)

    def _gray_drain(self, victim: str, now: float) -> None:
        """The ladder's drain rung: shed EVERY unresolved user off the
        probation host — queued via drop-acks, in-flight via checkpoint
        fences — WITHOUT retiring it (no drain record: probation
        already stops new routing, and a recovered host lifts back into
        rotation with its capacity intact).  Same one-wave-at-a-time /
        batch-plan discipline as ``_pump_remedy``; the journaled
        ``remedy`` record (action ``gray_drain``) is audit-only, every
        move commits on the source worker's ack."""
        if self._migrating or self._fencing or self._draining_host:
            return  # one ack-gated wave at a time keeps replay auditable
        cfg = self.config
        h = self.hosts.get(victim)
        targets = [t for t in self._route_targets() if t != victim]
        if h is None or not targets:
            return  # nowhere to shed; the autoscaler may add capacity
        st = self.journal.state
        mine = [u for u in st.assigned_to(victim)
                if u in self._unresolved]
        queued = [u for u in mine if st.last.get(u) == "enqueue"]
        in_flight = [u for u in mine if st.last.get(u) == "admit"]
        drops, fences = remedy_mod.pick_shed(
            queued, in_flight, len(mine),
            migrate_inflight=cfg.migrate_inflight)
        if not drops and not fences:
            return  # already empty: probation alone holds the line
        faults.fire("fabric.remedy", host=victim, action="gray_drain")
        rec = self.journal.append("remedy", host=victim,
                                  action="gray_drain")
        self.gray_drains += 1
        self.report.event("remedy", host=victim, action="gray_drain")
        self._ctl("ctl.remedy", key=rec["seq"], host=victim,
                  action="gray_drain", drops=len(drops),
                  fences=len(fences))
        drop_target = dict(placement_mod.plan_failover(
            drops, state=st, unresolved=self._unresolved, hosts=targets,
            edges=self._fleet_edges(), policy=cfg.placement,
            devices=self._host_devices()))
        for u in drops:
            self._migrating[u] = drop_target[u]
            h.assign.append({"drop": u})
            self.report.event("migrate_request", user=u,
                              host=drop_target[u])
        for u in fences:
            self._fencing[u] = victim
            self._fence_t[u] = now
            h.assign.append({"fence": u})
            self.report.event("migrate_request", user=u, host=victim)

    def _pump_depth(self, now: float) -> None:
        """The DEGRADATION dial (``depth_on_burn``): a probation host
        while the fleet's slo_headroom burn holds for ``depth_hold_s``
        is told to score with the cheap committee stage (``depth`` feed
        verb → ``Committee.depth_cap`` on the worker), restored the
        moment the burn clears (probation lift also restores).  The
        change is journaled (``remedy`` audit record, ``depth_change``
        event) and graded in telemetry; nothing replayed reads it."""
        cfg = self.config
        if not cfg.depth_on_burn:
            return
        from consensus_entropy_tpu_torch.obs import alerts as alerts_mod

        burning = bool(alerts_mod.slo_headroom_alerts(
            self._class_p95s(),
            {"interactive": cfg.slo_interactive_s,
             "batch": cfg.slo_batch_s}))
        for hid in sorted(self.journal.state.probation):
            if burning:
                self._depth_burn.setdefault(hid, now)
            else:
                self._depth_burn.pop(hid, None)
            held = self._depth_burn.get(hid)
            burn_held = None if held is None else now - held
            if remedy_mod.degrade_depth(True, burn_held,
                                        hold_s=cfg.depth_hold_s):
                if hid not in self._depth_cheap:
                    self._set_depth(hid, "cheap")
            elif hid in self._depth_cheap and not burning:
                self._set_depth(hid, "full")

    def _set_depth(self, hid: str, depth: str) -> None:
        h = self.hosts.get(hid)
        if h is None or not h.alive:
            return
        rec = self.journal.append("remedy", host=hid,
                                  action=f"depth_{depth}")
        self.depth_changes += 1
        self.report.event("depth_change", host=hid, depth=depth)
        self._ctl("ctl.depth", key=rec["seq"], host=hid, depth=depth)
        h.assign.append({"depth": depth})
        if depth == "cheap":
            self._depth_cheap.add(hid)
        else:
            self._depth_cheap.discard(hid)
            self._depth_burn.pop(hid, None)

    def _restore_depth(self, hid: str) -> None:
        """Probation lifted (or the host died): dial it back to full
        scoring if this coordinator degraded it."""
        if hid in self._depth_cheap:
            self._set_depth(hid, "full")
        self._depth_burn.pop(hid, None)

    def _adopt_operator_hosts(self) -> None:
        """Operator-added workers announce through the lease directory:
        a fresh ``lease_<id>.json`` for an id the coordinator never
        spawned is a JOIN request.  Adoption journals ``spawn`` (reason
        ``operator``) + ``lease`` and supervises the volunteer through a
        pid-only handle — same failover, same rebalance, same close
        semantics as a spawned worker.  Stale lease files (dead pid or
        expired beat) are ignored, and the ``max_hosts`` ceiling holds."""
        try:
            names = os.listdir(self.fabric_dir)
        except OSError:
            return
        for name in sorted(names):
            if not (name.startswith("lease_") and name.endswith(".json")):
                continue
            hid = name[len("lease_"):-len(".json")]
            if not hid or hid in self.hosts:
                continue
            paths = fabric_paths(self.fabric_dir, hid)
            lease = read_lease(paths["lease"])
            pid = lease.get("pid") if lease else None
            age = lease_age_s(paths["lease"], self._clock())
            if not isinstance(pid, int) or pid == os.getpid() \
                    or age is None or age > self.config.lease_s:
                continue  # dead run's artifact, not a live volunteer
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                continue  # lease is fresh but the process already died
            except PermissionError:
                # another uid's process: we could never SIGKILL it, so
                # failover could never guarantee it stopped — refuse
                # the adoption rather than break the one-host-per-user
                # invariant later
                self.report.event("host_adopt_refused", host=hid,
                                  pid=pid)
                continue
            if sum(1 for h in self.hosts.values() if h.alive) \
                    >= self.config.max_hosts:
                return  # at the ceiling: leave volunteers unadopted
            rec = self.journal.append("spawn", host=hid,
                                      reason="operator")
            self.spawns += 1
            self._register_host(hid, PidProc(pid, clock=self._clock),
                                paths)
            self.report.event("host_adopt", host=hid, pid=pid)
            self._ctl("ctl.spawn", key=rec["seq"], host=hid,
                      reason="operator")
            # the fresh lease means it already heartbeats: JOIN (and
            # rebalance onto it) on the next _check_hosts pass; one
            # adoption per poll keeps each join's rebalance settled
            # before the next
            return

    def _broadcast_edges(self) -> None:
        """One fleet-planner round: fold any newly-transcribed per-host
        sketches, and when an epoch derives CHANGED edges (journaled
        first — the decision is durable before anyone acts on it), push
        them over every live assignment feed so cross-host routing stays
        aligned with cross-host placement."""
        if self.fleet_planner is None:
            return
        new = self.fleet_planner.poll()
        if new is None:
            return
        for h in self.hosts.values():
            if h.alive:
                h.assign.append({"edges": list(new)})

    def _fail_over(self, h: HostHandle, reason: str) -> None:
        """Revoke one host and re-route its unresolved users.  The kill
        comes FIRST (a hung-but-alive worker must be dead before its
        users run elsewhere — no user may ever run on two hosts at once),
        the final event drain second (finishes it durably journaled
        before dying must resolve, not re-run), the re-routing last."""
        h.alive = False
        try:
            h.proc.kill()
            h.proc.wait(timeout=10)
        except Exception:
            pass
        self._transcribe(h)
        self._transcribe_spans(h)
        revoke_rec = self.journal.append("revoke", host=h.host_id,
                                         reason=reason)
        self.revocations += 1
        if not h.joined:
            # died before its first heartbeat: a stillborn spawn.  The
            # autoscaler refuses to keep fork-storming a systematically
            # broken worker (see _autoscale); any successful join resets
            self._stillborn += 1
        else:
            self._stillborn = 0
        if h.host_id == self._draining_host:
            # it died mid-drain: failover supersedes the graceful path
            # (revoke, not drain_done — the journal narrative says what
            # actually happened); the scale-down clock restarts
            self._draining_host = None
            h.draining = False
        # death supersedes the gray ladder: drop the liveness-only
        # evidence timers, and journal the probation lift so a respawn
        # of this slot starts back in rotation (the ladder re-earns any
        # new suspicion from fresh evidence)
        self._gray_hot.pop(h.host_id, None)
        self._gray_clean.pop(h.host_id, None)
        self._gray_last_event_t.pop(h.host_id, None)
        self._depth_burn.pop(h.host_id, None)
        self._depth_cheap.discard(h.host_id)
        if h.host_id in self.journal.state.probation:
            self.journal.append("probation", host=h.host_id, on=False)
            self.report.event("probation", host=h.host_id, on=False)
        # migrations whose TARGET just died stay pending on purpose: the
        # source may have already withdrawn the user (its ack is in
        # flight), so the ack handler must still see the entry and
        # re-place the user — dropping it here would strand a withdrawn
        # user in no queue at all.  Migrations whose SOURCE died are the
        # victims below: popped, because this reassignment supersedes
        # any stale ack (drop AND fence alike).
        victims = [u for u in self.journal.state.assigned_to(h.host_id)
                   if u in self._unresolved]
        self.report.event("host_down", host=h.host_id, reason=reason,
                          reassigned=len(victims))
        self._ctl("ctl.failover", key=revoke_rec["seq"], host=h.host_id,
                  reason=reason, reassigned=len(victims))
        for u in victims:
            self._migrating.pop(u, None)
            self._fencing.pop(u, None)
            self._fence_t.pop(u, None)
            self._fence_fallback.pop(u, None)
            # a parked (disconnected) victim is re-admitted by the
            # failover itself — the owner that was releasing it is dead,
            # so the pending evict ack will never come; resuming on a
            # survivor is exactly what the journal prescribes
            self._parked.discard(u)
            self._evict_pending.discard(u)
        # the WHOLE victim set is placed as one plan (in-flight first,
        # then queued — assigned_to's order): each placement folds into
        # the next decision's load/bucket view, so two same-bucket
        # victims of one dead host co-locate with each other, not just
        # with survivors.  With no live target the re-route is deferred
        # to the next JOIN (the stranded path) or the restart.
        self._route_batch(victims)
        self.reassignments += len(victims)

    def _close_hosts(self) -> None:
        """Graceful shutdown: every user is resolved, so workers are idle
        — send the close sentinel, give them ``drain_timeout_s`` to exit
        0, then SIGKILL stragglers (nothing left to lose)."""
        for h in self.hosts.values():
            if h.alive:
                h.closed = True
                h.assign.append({"close": True})
        deadline = self._clock() + self.config.drain_timeout_s
        for h in self.hosts.values():
            if h.alive:
                while h.proc.poll() is None and self._clock() < deadline:
                    time.sleep(self.config.poll_s)
                if h.proc.poll() is None:
                    self.report.event("drain_kill", host=h.host_id)
                    try:
                        h.proc.kill()
                        h.proc.wait(timeout=10)
                    except Exception:
                        pass
                self._transcribe(h)
                self._transcribe_spans(h)
            h.assign.close()
            h.tail.close()
            if h.span_tail is not None:
                h.span_tail.close()

    def _preempt_drain(self) -> None:
        """SIGTERM each worker (its own guard drains: in-flight sessions
        finish, queued users stay journaled), transcribe the finishes,
        then surface ``Preempted``."""
        from consensus_entropy_tpu_torch.resilience.preemption import Preempted

        self.report.event(
            "drain", unresolved=len(self._unresolved),
            reason="preemption requested; workers finish in-flight "
                   "sessions, queued users left for the rerun")
        for h in self.hosts.values():
            if h.alive:
                try:
                    h.proc.terminate()
                except Exception:
                    pass
        deadline = self._clock() + self.config.drain_timeout_s
        for h in self.hosts.values():
            if not h.alive:
                continue
            while h.proc.poll() is None and self._clock() < deadline:
                self._transcribe(h)
                time.sleep(self.config.poll_s)
            if h.proc.poll() is None:
                try:
                    h.proc.kill()
                    h.proc.wait(timeout=10)
                except Exception:
                    pass
            self._transcribe(h)
            self._transcribe_spans(h)
        raise Preempted(
            f"fabric drained: {len(self._unresolved)} user(s) left "
            "journaled for the rerun")

    def _kill_all(self) -> None:
        for h in self.hosts.values():
            try:
                h.proc.kill()
            except Exception:
                pass

    def _release_channels(self) -> None:
        for h in self.hosts.values():
            for ch in (h.assign, h.tail, h.span_tail):
                try:
                    if ch is not None:
                        ch.close()
                except Exception:
                    pass

    # -- the control-plane trace lane --------------------------------------

    def _ctl(self, name: str, *, key, flow_user=None, **attrs) -> None:
        """One control-plane decision span (``obs.trace.Tracer.
        control_event``): every journaled elastic/fabric decision lands
        in its own Perfetto lane, keyed by the decision's durable
        identity so a coordinator SIGKILL + replay re-emits identical
        ids and the merge dedupes.  Off without a tracer (``--no-trace``)
        and with ``introspect=False``."""
        if self.tracer is None or not self.tracer.enabled \
                or not self.introspect:
            return
        self.tracer.control_event(name, key=key, flow_user=flow_user,
                                  **attrs)

    # -- routing + transcription -------------------------------------------

    def _load_of(self, host_id: str) -> int:
        assigned = self.journal.state.assigned
        return sum(1 for u in self._unresolved
                   if assigned.get(u) == host_id)

    def _fleet_edges(self) -> tuple:
        """The bucket geometry placement co-locates by: the fleet
        planner's broadcast edges when it runs, else the last journaled
        planner edges (a restarted non-planner run keeps routing the
        same), else empty — ``placement.bucket_for`` then falls through
        to the power-of-two geometry every worker's default router
        shares."""
        if self.fleet_planner is not None and self.fleet_planner.edges:
            return self.fleet_planner.edges
        st_edges = self.journal.state.planner_edges
        return tuple(st_edges) if st_edges else ()

    def _host_is_live(self, host_id) -> bool:
        h = self.hosts.get(host_id) if host_id else None
        return h is not None and h.alive

    def _host_devices(self) -> dict | None:
        """``{host: chips}`` for devices-aware placement, from the
        widths workers advertise in their heartbeats (read at JOIN).
        ``None`` for an all-1-chip (or pre-mesh) fleet — placement then
        keeps the legacy co-location key bit-for-bit."""
        devs = {h.host_id: h.devices for h in self.hosts.values()
                if h.alive and h.devices and h.devices > 1}
        return devs or None

    def _route_targets(self) -> list:
        """Hosts a placement may target: alive, NOT draining — a
        draining host sheds users, it never receives them — and not on
        gray-failure PROBATION (the ladder's routing rung: a suspect
        host keeps its existing users but takes no new ones).  The
        probation exclusion is a preference, not a hard ban: when every
        live host is on probation the full list stands (progress over
        purity, the ``_assign`` exclude precedent)."""
        live = [h.host_id for h in self.hosts.values()
                if h.alive and not h.draining]
        prob = self.journal.state.probation
        if prob:
            live = [hid for hid in live if hid not in prob] or live
        return live

    def _assign(self, user: str, exclude: str | None = None) -> str | None:
        """Place and commit one user; returns the target host id, or
        ``None`` when no live non-draining target exists (the user
        keeps its stale assignment — the run loop raises FabricError,
        the autoscaler respawns, or the next JOIN's stranded path
        re-places it).  ``exclude``: a host this placement should avoid
        — the remedy fence commit passes the shed SOURCE, which (unlike
        a draining source) is still a live route target and would
        otherwise be re-picked the moment its released user lowered its
        load, flapping the user straight back onto the overloaded host.
        Preference, not a hard ban: when the source is the only live
        target the user still lands there (progress over purity)."""
        live = self._route_targets()
        if exclude is not None:
            live = [hid for hid in live if hid != exclude] or live
        if not live:
            return None
        # bucket-aware placement, a pure function of journaled state
        # (assignments, pool sizes, fleet edges): same-bucket users
        # co-locate so stacked dispatches stay full per host; with no
        # journaled pools it IS the least-loaded rule
        host_id = placement_mod.place_user(
            user, state=self.journal.state, unresolved=self._unresolved,
            hosts=live, edges=self._fleet_edges(),
            policy=self.config.placement,
            devices=self._host_devices())
        self._assign_to(user, host_id)
        return host_id

    def _route_batch(self, users) -> None:
        """Place ``users`` as ONE plan (``placement.plan_failover``) and
        journal each assignment in plan order — the batched sibling of
        :meth:`_assign`: each placement folds into the next decision's
        load/bucket view, so same-bucket users in the batch co-locate
        with each other.  With no live target the batch is deferred (the
        next JOIN's stranded path, or the restart, re-routes)."""
        live = self._route_targets()
        if not users or not live:
            return
        plan = placement_mod.plan_failover(
            users, state=self.journal.state,
            unresolved=self._unresolved, hosts=live,
            edges=self._fleet_edges(), policy=self.config.placement,
            devices=self._host_devices())
        for u, target in plan:
            self._assign_to(u, target)

    def _assign_to(self, user: str, host_id: str) -> None:
        h = self.hosts[host_id]
        # a kill here models the coordinator dying between choosing a
        # route and journaling it: the user's last record stays
        # enqueue/fail, so the restarted coordinator re-routes it
        faults.fire("fabric.assign", user=user, host=h.host_id)
        self.journal.append("assign", user, host=h.host_id)
        # the assignment feed carries the user's priority class so the
        # worker's class-aware queue pops it correctly (failover
        # included — the journal remembers first-submit classes)
        cls = self.journal.state.classes.get(user)
        h.assign.append({"user": user, **({"cls": cls} if cls else {})})
        self.report.event("assign", user=user, host=h.host_id)

    def _transcribe(self, h: HostHandle) -> None:
        """Fold the host's durable events into the main journal.  Each
        transcription carries ``src_off`` — the byte cursor after the
        consumed line — so a restarted coordinator's replay resumes the
        tail exactly where the journal proves it left off (an event is
        transcribed at-least-zero, never twice)."""
        for rec, off in h.tail.poll():
            # any transcribed event resets the host's append-age gray
            # signal (liveness-only telemetry; replay never reads it)
            self._gray_last_event_t[h.host_id] = self._clock()
            ev, u = rec.get("event"), rec.get("user")
            if ev == "admit":
                self.journal.append("admit", u, host=h.host_id,
                                    src_off=off)
                # burn-detector sample start (liveness-only telemetry;
                # replay never reads it)
                self._admit_t.setdefault(u, self._clock())
            elif ev == "finish":
                self.journal.append("finish", u, host=h.host_id,
                                    src_off=off)
                t_admit = self._admit_t.pop(u, None)
                if t_admit is not None:
                    self._lat[self.journal.state.classes.get(
                        u, "batch")].append(self._clock() - t_admit)
                self._unresolved.discard(u)
                self._parked.discard(u)
                self._evict_pending.discard(u)
                self._migrating.pop(u, None)
                self._fencing.pop(u, None)
                self._fence_t.pop(u, None)
                self._fence_fallback.pop(u, None)
                self._note_finish()
                self.report.event("user_finished", user=u, host=h.host_id)
            elif ev == "poison":
                self.journal.append("poison", u, host=h.host_id,
                                    src_off=off, error=rec.get("error"))
                if u not in self.poison:
                    self.poison.add(u, error=str(rec.get("error")),
                                    attempts=int(rec.get("attempts") or 0))
                self._unresolved.discard(u)
                self._parked.discard(u)
                self._evict_pending.discard(u)
                self.report.event("user_poisoned", user=u,
                                  host=h.host_id)
            elif ev == "fail":
                fields = {"host": h.host_id, "src_off": off,
                          "error": rec.get("error")}
                if rec.get("final"):
                    fields["final"] = True
                self.journal.append("fail", u, **fields)
                if rec.get("final"):
                    # the worker's whole recovery ladder (evict → resume
                    # → backoff re-admission) is spent: resolved with an
                    # error THIS run; a coordinator restart re-admits it,
                    # same as the single-host journal semantics
                    self._failed.add(u)
                    self._unresolved.discard(u)
                    self._parked.discard(u)
                    self._evict_pending.discard(u)
                    self.report.event("user_failed_final", user=u,
                                      host=h.host_id,
                                      error=rec.get("error"))
            elif ev == "drop":
                # the rebalance ack: the source worker either withdrew
                # the still-queued user (ok → the move commits: journal
                # the ack for the cursor, then re-assign) or had already
                # admitted it (refused → it runs where it is).  Only a
                # migration pending THIS run may act: a stale ack
                # re-read after a coordinator restart (the cursor may
                # predate it) just advances the cursor — the restart
                # already re-routed every pending user from the journal
                self.journal.append(
                    "drop", u, host=h.host_id, src_off=off,
                    ok=bool(rec.get("ok")),
                    **({"ep": rec["ep"]}
                       if isinstance(rec.get("ep"), int) else {}))
                # the ack span keys on (host, src_off) — the worker-WAL
                # byte identity a stale re-read after a coordinator
                # restart shares, so replay re-emits the SAME id and the
                # merge dedupes (journal seq would fork: stale acks
                # re-journal under a new seq)
                self._ctl("ctl.rebalance", key=(h.host_id, off), user=u,
                          ok=bool(rec.get("ok")),
                          flow_user=u if rec.get("ok") else None)
                ep = rec.get("ep")
                if isinstance(ep, int) and ep != self.epoch:
                    # an ack stamped by ANOTHER coordinator incarnation:
                    # cursor-only (journaled above), and this run's own
                    # pending state stays UNTOUCHED — committing a
                    # predecessor's negotiated hand-off could double-own
                    # the user the restart already re-routed
                    self.report.event("epoch_fenced", user=u,
                                      host=h.host_id, epoch=ep)
                    continue
                target = self._migrating.pop(u, None)
                # whichever ack commits a deadline-demoted fence first
                # (this drop, or the racing checkpoint fence) clears the
                # fallback entry; the loser's ack is then cursor-only
                self._fence_fallback.pop(u, None)
                if u in self._evict_pending:
                    # the DISCONNECT evict ack: the old owner provably
                    # released (or never held) the user — a reconnect
                    # that already arrived may now route; a still-parked
                    # user waits for its reconnect (or the close-time
                    # re-admission)
                    self._evict_pending.discard(u)
                    if u not in self._parked and u in self._unresolved:
                        if self._hold_until is not None:
                            self._unrouted.append(u)
                        else:
                            self._assign(u)
                    continue
                if target is None:
                    continue
                if rec.get("ok") and u in self._unresolved:
                    th = self.hosts.get(target)
                    if th is not None and th.alive and not th.draining:
                        self._assign_to(u, target)
                    else:
                        self._assign(u)  # target died mid-move: re-place
                    self.migrations += 1
                    self.report.event("migrate", user=u, host=target)
                    self._ctl("ctl.migrate", key=("q", h.host_id, off),
                              user=u, host=target, kind="queued",
                              flow_user=u)
                elif not rec.get("ok"):
                    self.report.event("migrate_refused", user=u)
            elif ev == "fence":
                # the in-flight-migration ack: the source worker either
                # RELEASED the user at a checkpoint boundary (ok — the
                # fenced workspace, generation ``gen``, is the resume
                # unit) or refused (not running there: finished first,
                # or never admitted).  The fence is journaled BEFORE the
                # commit (its own fault point), and only a fence pending
                # THIS run commits the re-assign — a stale ack re-read
                # after a coordinator restart advances the cursor only,
                # exactly like stale drop acks: the restart already
                # re-routed every unresolved user from the journal.
                faults.fire("fabric.migrate.fence", user=u,
                            host=h.host_id)
                self.journal.append(
                    "fence", u, host=h.host_id, src_off=off,
                    ok=bool(rec.get("ok")), gen=rec.get("gen"),
                    **({"ep": rec["ep"]}
                       if isinstance(rec.get("ep"), int) else {}))
                self.report.event("migrate_fence", user=u,
                                  host=h.host_id,
                                  ok=bool(rec.get("ok")),
                                  gen=rec.get("gen"))
                # keyed on the worker-WAL byte identity, like drop acks
                self._ctl("ctl.fence", key=(h.host_id, off), user=u,
                          host=h.host_id, ok=bool(rec.get("ok")),
                          gen=rec.get("gen"),
                          flow_user=u if rec.get("ok") else None)
                ep = rec.get("ep")
                if isinstance(ep, int) and ep != self.epoch:
                    # foreign-incarnation fence ack: cursor-only, same
                    # rule as stale drop acks above
                    self.report.event("epoch_fenced", user=u,
                                      host=h.host_id, epoch=ep)
                    continue
                src = self._fencing.pop(u, None)
                self._fence_t.pop(u, None)
                if src is None:
                    src = self._fence_fallback.pop(u, None)
                    if src is None:
                        continue  # stale ack (restart): cursor-only
                    # a deadline-DEMOTED fence whose checkpoint-boundary
                    # release raced the evict verb and won: the boundary
                    # release is strictly better than the evict we fell
                    # back to — commit the move to the demotion's target
                    # (the evict's refused drop ack is then cursor-only,
                    # its _migrating entry popped here)
                    target = self._migrating.pop(u, None)
                    if rec.get("ok") and u in self._unresolved:
                        faults.fire("fabric.migrate.commit", user=u,
                                    host=src)
                        th = self.hosts.get(target) if target else None
                        if th is not None and th.alive \
                                and not th.draining:
                            self._assign_to(u, target)
                        else:
                            # demotion target died mid-race: re-place,
                            # still avoiding the shed source
                            target = self._assign(u, exclude=src)
                        if target is not None:
                            self.migrations += 1
                            self.fences += 1
                            self.report.event("migrate_inflight",
                                              user=u, host=target,
                                              gen=rec.get("gen"))
                            self._ctl("ctl.migrate",
                                      key=("i", h.host_id, off),
                                      user=u, host=target,
                                      kind="inflight",
                                      gen=rec.get("gen"), flow_user=u)
                    elif not rec.get("ok"):
                        self.report.event("migrate_refused", user=u)
                    continue
                if rec.get("ok") and u in self._unresolved:
                    # a kill here dies with the fence journaled but the
                    # re-assign uncommitted: the user's last assignment
                    # still names the (retiring) source, so the restart
                    # re-places it — exactly one owner either way
                    faults.fire("fabric.migrate.commit", user=u,
                                host=src)
                    # a draining source is already off the route-target
                    # list; a remedy-shed source is NOT — exclude it so
                    # the released user cannot flap straight back
                    target = self._assign(u, exclude=src)
                    if target is not None:
                        self.migrations += 1
                        self.fences += 1
                        self.report.event("migrate_inflight", user=u,
                                          host=target,
                                          gen=rec.get("gen"))
                        self._ctl("ctl.migrate",
                                  key=("i", h.host_id, off), user=u,
                                  host=target, kind="inflight",
                                  gen=rec.get("gen"), flow_user=u)
                    # no live target: the released user keeps its stale
                    # assignment to the retiring source — the next JOIN
                    # (stranded path) or the restart re-places it; no
                    # migration happened, so nothing is counted
                elif not rec.get("ok"):
                    self.report.event("migrate_refused", user=u)
            elif ev == "planner":
                # the worker's SLO-planner epoch: its sketch state is
                # the fleet planner's per-host telemetry feed (bytes
                # covered by the next cursor-carrying record — re-noting
                # a sketch after a restart is idempotent)
                if self.fleet_planner is not None:
                    self.fleet_planner.note_host_sketch(
                        h.host_id, rec.get("sketch"))
            elif ev == "epoch_fenced":
                # the worker refused a stale-incarnation feed line: fold
                # the audit record (cursor advance) and surface it
                self.journal.append("epoch_fenced", u, host=h.host_id,
                                    src_off=off,
                                    epoch=int(rec.get("epoch") or 0))
                self.report.event("epoch_fenced", host=h.host_id,
                                  epoch=int(rec.get("epoch") or 0),
                                  **({"user": u} if u else {}))
            # worker-local enqueue/requeue records are flow bookkeeping,
            # not dispositions the fabric needs — skipped (their bytes
            # are covered by the next transcribed record's cursor)
        if h.tail.corrupt > h.corrupt_seen:
            # the tail skipped complete-but-corrupt WAL lines (bit-rot
            # on another process's file — quarantined to the sidecar,
            # never acted on): surface each batch once
            self.report.event("record_quarantined", host=h.host_id,
                              path=h.tail.path)
            h.corrupt_seen = h.tail.corrupt

    def _note_finish(self) -> None:
        """Fold one observed user completion into the finish-interval
        EMA — the SLO-headroom scale-up signal's drain predictor (wall
        clock through the injected seam; telemetry only, nothing
        journaled reads it)."""
        now = self._clock()
        if self._last_finish_t is not None:
            self._finish_ema = metrics_ema(
                self._finish_ema, max(now - self._last_finish_t, 0.0))
        self._last_finish_t = now

    def _transcribe_spans(self, h: HostHandle) -> None:
        """Fold the host's span WAL into the coordinator's tracer sink.
        The cursor is in-memory only (spans are telemetry, not a ledger):
        a coordinator restart re-reads from 0 and the deterministic span
        ids collapse the duplicates at merge time."""
        if h.span_tail is None:
            return
        for rec, _off in h.span_tail.poll():
            self.tracer.transcribe(rec, host=h.host_id)

    # -- live introspection ------------------------------------------------

    def _status_payload(self) -> dict:
        """The coordinator's fleet-wide snapshot: per-host liveness
        (lease ages through the injected clock), drain/fence/migration
        progress, unresolved counts, the broadcast bucket edges and the
        active alerts.  Lease-expiry burn alerts evaluate here — the
        coordinator is the only process that watches every lease."""
        now = self._clock()
        st = self.journal.state
        hosts: dict = {}
        for hid, h in self.hosts.items():
            age = lease_age_s(h.lease_path, now) if h.alive else None
            hosts[hid] = {
                "alive": h.alive, "joined": h.joined,
                "draining": h.draining,
                "lease_age_s": round(age, 3) if age is not None else None,
                "load": self._load_of(hid),
                "devices": h.devices,
            }
        if self.alerts is not None:
            # the COMPOSED list (lease burn + placement skew) — the
            # same one _pump_remedy feeds, so the snapshot-based
            # watcher's two call sites never delete each other's keys
            self.alerts.update(self._evaluate_alerts())
        payload = {
            "hosts": hosts,
            "unresolved": len(self._unresolved),
            "queued": sum(1 for u in st.queued
                          if u in self._unresolved),
            "in_flight": sum(1 for u in st.in_flight
                             if u in self._unresolved),
            "spawns": self.spawns, "joins": self.joins,
            "migrations": self.migrations, "drains": self.drains,
            "fences": self.fences, "revocations": self.revocations,
            "remedies": self.remedies,
            "fence_timeouts": self.fences_timed_out,
            "fencing": len(self._fencing),
            "draining_host": self._draining_host,
            "probation": sorted(st.probation),
            "probations": self.probations,
            "gray_drains": self.gray_drains,
            "depth_changes": self.depth_changes,
            "depth_cheap": sorted(self._depth_cheap),
            "edges": list(self._fleet_edges()) or None,
            "holds": self.holds,
            "hold_active": self._hold_until is not None,
            "parked": len(self._parked),
            "disconnects": self.disconnects,
            "reconnects": self.reconnects,
        }
        if self.fleet_planner is not None:
            payload["fleet_planner"] = self.fleet_planner.summary()
        if self.alerts is not None:
            payload["alerts"] = self.alerts.active
            # the sinks' delivery failures (the --alert-sink help's count)
            payload["alert_sink_errors"] = self.alerts.sink_errors
        return payload

    # -- summary -----------------------------------------------------------

    def _summary(self) -> dict:
        st = self.journal.state
        sub = set(self._submitted)
        summary = {
            "users": len(self._submitted),
            "finished": sorted(u for u in sub if u in st.finished),
            "failed": sorted(self._failed),
            "poisoned": sorted(u for u in sub if u in st.poisoned),
            "revocations": self.revocations,
            "reassignments": self.reassignments,
            "spawns": self.spawns,
            "joins": self.joins,
            "migrations": self.migrations,
            "drains": self.drains,
            "fences": self.fences,
            "remedies": self.remedies,
            "fence_timeouts": self.fences_timed_out,
            "probations": self.probations,
            "gray_drains": self.gray_drains,
            "depth_changes": self.depth_changes,
            "holds": self.holds,
            "disconnects": self.disconnects,
            "reconnects": self.reconnects,
            "compactions": self.journal.compactions,
            "hosts": {hid: ("drained" if h.draining and not h.alive
                            else "revoked" if not h.alive else "closed")
                      for hid, h in self.hosts.items()},
        }
        if self.fleet_planner is not None:
            summary["fleet_planner"] = self.fleet_planner.summary()
        if self.config.drain_host is not None \
                and not self._operator_drained:
            # the operator command was never serviced (typo'd host id,
            # or the run resolved before the host ever joined) — a
            # silent exit 0 would read as "drained"; surface it in the
            # summary AND the event stream so the CLI can warn
            summary["drain_host_unserviced"] = self.config.drain_host
            self.report.event(
                "drain", reason=f"--drain-host {self.config.drain_host} "
                "was never serviced: the host never became live+joined "
                "during this run")
        self.report.event(
            "fabric_summary", users=summary["users"],
            finished=len(summary["finished"]),
            failed=len(summary["failed"]),
            poisoned=len(summary["poisoned"]),
            revocations=self.revocations,
            reassignments=self.reassignments,
            spawns=self.spawns, joins=self.joins,
            migrations=self.migrations, drains=self.drains,
            fences=self.fences,
            compactions=summary["compactions"])
        return summary
