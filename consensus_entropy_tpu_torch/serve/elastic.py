"""The elastic control plane of the serve fabric: autoscaling + fleet
planning.

Counterpart of ``consensus_entropy_tpu/serve/elastic.py``.  It replaces
dead capacity, lets a fresh host join a running fabric and merges the
workers' SLO planner sketches into one edge set, run by the :class:`~consensus_entropy_tpu_torch.serve.fabric.FabricCoordinator`
when ``FabricConfig.min_hosts``/``max_hosts`` are set:

- :func:`target_hosts` — the AUTOSCALER's sizing rule, a pure function
  of journaled state plus two telemetry signals: queue-depth (queued
  backlog per live host past ``scale_backlog``) and SLO-headroom
  (predicted queue-drain time past ``scale_slo_s``, using the observed
  per-user finish EMA).  Clamped to ``[min_hosts, max_hosts]``; dead
  capacity below ``min_hosts`` is always replaced.  Every spawn decision
  is journaled (``spawn`` record, ``fabric.spawn`` fault point BEFORE
  the append), so a restarted coordinator replays the same fleet shape.
- :func:`next_host_id` — deterministic host-id allocation: replacements
  get FRESH ids (``h2``, ``h3``, …) so a dead host's event WAL and its
  transcription cursor are never reused by a different process.
- :class:`FleetPlanner` — fabric-level admission planning: each worker's
  SLO planner journals its quantile sketch per epoch into its own event
  WAL; the coordinator folds the latest sketch per host into ONE merged
  view (``QuantileSketch.merge`` is associative, so fold order is
  irrelevant), re-derives bucket edges every ``planner_epoch`` merged
  observations, journals the epoch (edges + merged sketch — the
  restart-restore record), and the coordinator broadcasts the edges over
  every assignment feed so cross-host ROUTING stays aligned with
  cross-host PLACEMENT (``serve.placement`` buckets by the same edges).
- :class:`PidProc` — the Popen-shaped shim for OPERATOR-ADDED workers: a
  worker started by hand announces itself through the lease directory
  (its lease file is the join request); the coordinator adopts it with
  only a pid to supervise.

Liveness reads go through the coordinator's injected wall clock; nothing
here feeds journaled results, so replay never reads a clock.
"""

from __future__ import annotations

import os
import re
import signal

from consensus_entropy_tpu_torch.obs.metrics import QuantileSketch
from consensus_entropy_tpu_torch.serve.planner import derive_edges

_HOST_ID = re.compile(r"^h(\d+)$")


def next_host_id(existing) -> str:
    """The next fresh ``h<N>`` id after every id the fleet has EVER used
    (journaled membership + live handles): replacements must not reuse a
    dead host's id — its event WAL and durable transcription cursor
    belong to the dead process."""
    top = -1
    for hid in existing:
        m = _HOST_ID.match(str(hid))
        if m:
            top = max(top, int(m.group(1)))
    return f"h{top + 1}"


def target_hosts(*, live: int, queued: int, min_hosts: int,
                 max_hosts: int, scale_backlog: int = 8,
                 scale_slo_s: float = 0.0,
                 finish_ema_s: float | None = None) -> int:
    """The autoscaler's desired fleet size.

    Pure decision kernel:

    - never below ``min_hosts`` — dead capacity is REPLACED, the
      fold-onto-survivors-forever gap;
    - scale up one host per decision while the queue-depth signal fires
      (``queued > scale_backlog * live`` — each live host is already
      oversubscribed by a full backlog) or the SLO-headroom signal fires
      (``queued * finish_ema_s > scale_slo_s`` — the observed per-user
      finish rate predicts the backlog outlives the headroom);
    - never above ``max_hosts`` (the operator's spend ceiling).

    One host per decision, not a jump to the predicted size: each spawn
    pays a real process + torch-import cost, and the next poll re-decides
    with the joiner already absorbing load."""
    want = max(live, min_hosts)
    scale_up = queued > scale_backlog * max(live, 1)
    if not scale_up and scale_slo_s > 0 and finish_ema_s is not None:
        scale_up = queued * finish_ema_s > scale_slo_s
    if scale_up and live >= min_hosts:
        want = live + 1
    return max(min_hosts, min(want, max_hosts))


def scale_down_ok(*, live: int, queued: int, min_hosts: int,
                  scale_backlog: int = 8, scale_slo_s: float = 0.0,
                  finish_ema_s: float | None = None) -> bool:
    """True when the fleet could serve its load one host SMALLER without
    immediately scaling back up — the LOW-WATER test the drain decision
    requires to hold for a sustained ``scale_down_s`` before a surplus
    host drains.  Pure decision kernel:

    - never below ``min_hosts`` (and a 1-host fleet can't shrink);
    - quiet queue-depth signal at ``live - 1``: the backlog would NOT
      oversubscribe the smaller fleet (``queued <= scale_backlog *
      (live - 1)`` — the exact inverse of :func:`target_hosts`'s
      scale-up trigger, evaluated at the post-drain size, which is what
      makes drain/spawn hysteresis-free at the boundary);
    - quiet SLO-headroom signal at ``live - 1``: the predicted drain
      time of the backlog on the smaller fleet stays inside the target
      (scaled by ``live/(live-1)`` — one fewer host serves that much
      slower).

    The SUSTAINED requirement (the low-water mark must hold for
    ``scale_down_s`` continuous seconds) lives in the coordinator: this
    kernel is the instantaneous test it times."""
    if live <= max(min_hosts, 1):
        return False
    smaller = live - 1
    if queued > scale_backlog * smaller:
        return False
    if scale_slo_s > 0 and finish_ema_s is not None:
        if queued * finish_ema_s * (live / smaller) > scale_slo_s:
            return False
    return True


def drain_victim(loads: dict) -> str:
    """The host a scale-down drains: fewest unresolved users (least
    sunk work to shed), ties broken toward the HIGHEST host id — the
    newest capacity goes first, so repeated drains walk the fleet back
    toward its original ids (the mirror of ``_initial_fleet``'s clamp
    keeping the lowest-numbered hosts).  ``loads``: unresolved-user
    count per live, joined, non-draining host."""
    if not loads:
        raise ValueError("no drainable hosts")

    def key(hid):
        m = _HOST_ID.match(str(hid))
        # numeric ids after non-numeric (drain hand-named volunteers
        # first), highest number first within numeric
        num = -int(m.group(1)) if m else float("inf")
        return (loads[hid], 0 if m is None else 1, num, str(hid))

    return min(loads, key=key)


class FleetPlanner:
    """Fabric-level bucket planning over the per-host sketches.

    ``journal``: the MAIN admission journal — construction restores the
    last fleet ``planner`` record (edges + merged sketch at that epoch),
    so a restarted coordinator rebroadcasts the killed run's edges to
    its fresh workers before any new telemetry arrives.  Per-host
    sketches then stream in through :meth:`note_host_sketch` (the
    coordinator transcription loop feeds it every worker ``planner``
    record it tails) and :meth:`poll` re-derives once ``epoch`` NEW
    merged observations accumulated — journaling each epoch before the
    caller broadcasts it, so the decision is durable before any worker
    acts on it."""

    def __init__(self, journal, *, epoch: int = 8, n_buckets: int = 4,
                 report=None, tracer=None):
        self.journal = journal
        self.epoch = epoch
        self.n_buckets = n_buckets
        self.report = report
        #: optional ``obs.trace.Tracer``: each derivation epoch lands in
        #: the control-plane lane, keyed by its journal record's seq
        self.tracer = tracer
        self.edges: tuple = ()
        self.edge_updates = 0
        #: latest journaled sketch per worker host (dict form — merged
        #: lazily per poll; merge is associative so the fold order over
        #: sorted host ids is one canonical chain)
        self._host_sketch: dict[str, dict] = {}
        #: the restored pre-restart merged sketch — the view until fresh
        #: per-host telemetry arrives.  Once any host journals a new
        #: sketch the per-host set REPLACES it wholesale: a respawned
        #: host's own WAL replay restores its full history (superset of
        #: its old contribution), so folding the baseline in again would
        #: double-count every surviving host's observations
        self._base: dict | None = None
        self._derived_n = 0
        if journal is not None:
            edges, sketch, _ = journal.planner_state()
            if edges:
                self.edges = tuple(int(e) for e in edges)
            if sketch:
                self._base = sketch
                self._derived_n = int(sketch.get("n", 0))

    def note_host_sketch(self, host: str, sketch: dict) -> None:
        if isinstance(sketch, dict):
            self._host_sketch[str(host)] = sketch

    def merged(self) -> QuantileSketch:
        """One fleet-wide sketch: the per-host sketches folded in host-id
        order (associativity makes the order irrelevant; sorting makes
        the chain canonical anyway).  With no per-host telemetry yet,
        the restored baseline alone."""
        if self._host_sketch:
            return QuantileSketch.merge_all(
                self._host_sketch[h] for h in sorted(self._host_sketch))
        if self._base is not None:
            return QuantileSketch.from_dict(self._base)
        return QuantileSketch()

    def poll(self) -> tuple | None:
        """Derive once ``epoch`` new merged observations accumulated;
        returns the NEW edges when they changed (the caller broadcasts),
        ``None`` otherwise.  Every derivation journals a fleet
        ``planner`` record first — edges plus the merged sketch — so a
        coordinator restart restores this exact planner."""
        sk = self.merged()
        if sk.n < self._derived_n + self.epoch:
            return None
        self._derived_n = sk.n
        edges = derive_edges(sk, n_buckets=self.n_buckets)
        changed = bool(edges) and edges != self.edges
        if changed:
            self.edges = edges
            self.edge_updates += 1
        rec = None
        if self.journal is not None:
            rec = self.journal.append("planner", edges=list(self.edges),
                                      sketch=sk.to_dict())
        if changed and self.report is not None:
            self.report.event("fleet_edges", edges=list(edges),
                              observations=sk.n)
        if rec is not None and self.tracer is not None \
                and self.tracer.enabled:
            self.tracer.control_event(
                "ctl.planner_epoch", key=rec["seq"],
                edges=list(self.edges), observations=sk.n,
                changed=changed)
        return edges if changed else None

    def summary(self) -> dict:
        return {"edges": list(self.edges) if self.edges else None,
                "edge_updates": self.edge_updates,
                "hosts_sketching": sorted(self._host_sketch),
                "observations": self.merged().n}


class PidProc:
    """A Popen-shaped handle over a process the coordinator did NOT
    spawn — the operator-added worker adopted through the lease
    directory.  Implements the subset the coordinator drives:
    ``pid`` / ``poll()`` / ``kill()`` / ``wait(timeout)``.  ``clock`` is
    the coordinator's injected wall clock (liveness only)."""

    def __init__(self, pid: int, *, clock):
        self.pid = int(pid)
        self._clock = clock

    def poll(self):
        try:
            os.kill(self.pid, 0)
        except ProcessLookupError:
            return -1  # gone
        except PermissionError:
            # EPERM means the process EXISTS but belongs to another
            # uid: it is ALIVE — declaring it dead would re-route its
            # users while it still runs them (adoption refuses
            # unsignalable pids up front, so this is belt-and-braces)
            return None
        return None

    def kill(self) -> None:
        try:
            os.kill(self.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def wait(self, timeout: float | None = None):
        deadline = None if timeout is None else self._clock() + timeout
        while self.poll() is None:
            if deadline is not None and self._clock() >= deadline:
                raise TimeoutError(f"pid {self.pid} still alive")
            import time as _time

            _time.sleep(0.02)
        return -1
