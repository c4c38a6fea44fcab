"""Worker-host side of the multi-host serve fabric.

Counterpart of ``consensus_entropy_tpu/serve/hosts.py``.  A fabric worker
is one process running one :class:`~consensus_entropy_tpu_torch.serve.
server.FleetServer` over its devices.  It talks to the coordinator
(:mod:`serve.fabric`) through files only, in the JAX package's layout and
bytes, so a fabric directory replays in either package; no process group
joins the workers (NCCL refuses two ranks on one card, and the fabric
needs no collective):

- ``fabric/assign_<host>.jsonl`` (coordinator to worker): one line per
  routed user (``{"user": ...}``), the control verbs (``drop``, ``fence``,
  ``drain``, ``edges``, ``depth``) and a final ``{"close": true}``.  The
  worker tails it with :class:`~consensus_entropy_tpu_torch.serve.journal.
  JsonlTail` and submits each user into its server's admission queue (a
  full queue delays the submit: the tail position is the flow control).
- ``fabric/events_<host>.jsonl`` (worker to coordinator): the worker's own
  :class:`~consensus_entropy_tpu_torch.serve.journal.AdmissionJournal`;
  the coordinator tails it and transcribes it into the main journal.
  Each side writes only its own file (single-writer WALs).
- ``fabric/lease_<host>.json`` (worker to coordinator): the heartbeat.
  :class:`HostLease` rewrites it atomically every ``interval_s``; the
  coordinator treats a beat older than the lease as a dead or hung
  worker and fails its users over.  The heartbeat thread also detects an
  orphan: when the coordinator dies the worker is re-parented and exits
  hard (``EXIT_ORPHANED``) rather than race a restarted coordinator's
  fresh workers for the same workspaces.
- ``fabric/spans_<host>.jsonl`` and ``fabric/log_<host>.txt``: the
  worker's span WAL (transcribed like the events) and its output.

The worker never needs a clean shutdown: a SIGKILL at any instant leaves
the workspaces resumable (two-phase commit), the event journal
torn-tail recoverable and the lease stale, the three signals the
coordinator's failover reads.
"""

from __future__ import annotations

import os
import threading
import time
import zlib

import numpy as np

from consensus_entropy_tpu_torch.resilience import faults
from consensus_entropy_tpu_torch.resilience import io as dio
from consensus_entropy_tpu_torch.resilience.retry import backoff_delay
from consensus_entropy_tpu_torch.serve.journal import AdmissionJournal, JsonlTail
from consensus_entropy_tpu_torch.serve.server import (
    FleetServer,
    QueueClosed,
    QueueFull,
)

#: worker process exit codes (beyond the CLI's EXIT_PREEMPTED=75)
EXIT_ORPHANED = 76

FABRIC_SUBDIR = "fabric"


def fabric_paths(fabric_dir: str, host_id: str) -> dict:
    """The three per-host channel paths plus the worker's stdout log."""
    return {
        "assign": os.path.join(fabric_dir, f"assign_{host_id}.jsonl"),
        "events": os.path.join(fabric_dir, f"events_{host_id}.jsonl"),
        "lease": os.path.join(fabric_dir, f"lease_{host_id}.json"),
        "log": os.path.join(fabric_dir, f"log_{host_id}.txt"),
        # the worker's span WAL (obs.trace.Tracer sink) — the coordinator
        # tails + transcribes it like the event WAL; span ids are
        # deterministic, so at-least-once transcription merges clean
        "spans": os.path.join(fabric_dir, f"spans_{host_id}.jsonl"),
    }


def read_lease(path: str) -> dict | None:
    """The last heartbeat a worker managed to publish, or ``None`` (never
    beat, or a torn write — the atomic rename makes the latter a
    never-happened)."""
    import json

    try:
        with open(path, "rb") as f:
            rec = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError, UnicodeDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


def lease_age_s(path: str, now: float | None = None) -> float | None:
    """Seconds since the worker's last heartbeat (wall clock — the lease
    file crosses processes, so monotonic clocks don't compare)."""
    rec = read_lease(path)
    if rec is None or not isinstance(rec.get("t"), (int, float)):
        return None
    return (time.time() if now is None else now) - rec["t"]


class EpochGate:
    """Worker-side half of the coordinator fencing-epoch protocol (pure
    logic — unit-testable without a fabric).

    The coordinator stamps every assignment-feed line with its fencing
    epoch (``ep``, claimed monotonically in the journal per
    incarnation).  The gate latches the HIGHEST epoch it has seen and
    :meth:`admit` rejects any line below it: once a successor
    coordinator's first line arrives, a wedged predecessor's late writes
    can never route users, request fences, or withdraw sessions here —
    the split-brain half of the single-owner invariant.  Legacy feeds
    (no ``ep`` field) pass untouched, and the latched epoch is echoed on
    every ack so the coordinator can discard foreign-incarnation acks as
    cursor-only."""

    def __init__(self):
        self.epoch: int | None = None
        self.fenced = 0

    def admit(self, rec: dict) -> bool:
        ep = rec.get("ep")
        if not isinstance(ep, int):
            return True
        if self.epoch is None or ep > self.epoch:
            self.epoch = ep
            return True
        if ep < self.epoch:
            self.fenced += 1
            return False
        return True


class HostLease:
    """The worker's heartbeat writer (daemon thread).

    Every ``interval_s`` it fires the ``fabric.lease`` fault point (an
    injected kill/delay there models a dead or wedged heartbeat while the
    engine may still be running — the coordinator must SIGKILL + fail
    over on lease age alone) and atomically replaces the lease file.

    ``orphan_check``: when the spawning coordinator dies, this process is
    re-parented (``getppid`` changes); the heartbeat thread then exits the
    WHOLE process hard via ``os._exit(EXIT_ORPHANED)`` — crash semantics,
    which the recovery machinery is already pinned against — so orphans
    never race a restarted coordinator's fresh workers for the same
    workspaces."""

    def __init__(self, path: str, host_id: str, interval_s: float, *,
                 orphan_check: bool = True, devices: int | None = None,
                 step_source=None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.path = path
        self.host_id = host_id
        self.interval_s = interval_s
        #: chips this worker serves with (its pool-mesh width); carried
        #: in every beat so the coordinator's placement can route wide
        #: buckets toward multi-chip hosts.  ``None`` = legacy beat
        #: (no ``devices`` field), coordinator treats as 1
        self.devices = devices
        #: optional zero-arg callable returning this worker's current
        #: dispatch step-wall EMA in seconds (or ``None``); carried in
        #: every beat as ``step_ema_s`` so the coordinator's gray
        #: detector can compare each host's device-step wall against the
        #: fleet's peers.  Telemetry only — replay never reads a lease.
        self.step_source = step_source
        self.beats = 0
        self._orphan_check = orphan_check
        self._ppid = os.getppid()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat_once(self) -> None:
        """One heartbeat: fault point, then tmp-write + atomic rename (a
        reader sees the previous beat or this one, never a torn file).
        A ``slow`` rule on ``fabric.lease`` stretches the whole beat
        PERIOD (``slow_hold`` over ``interval_s``) — the late-heartbeat
        gray species: beats keep landing, each one F intervals apart."""
        import json

        self.beats += 1
        faults.fire("fabric.lease", host=self.host_id, beat=self.beats)
        rec = {"host": self.host_id, "pid": os.getpid(),
               "beat": self.beats,
               "t": round(time.time(), 3)}
        if self.devices is not None:
            rec["devices"] = int(self.devices)
        if self.step_source is not None:
            step = self.step_source()
            if isinstance(step, (int, float)):
                rec["step_ema_s"] = round(float(step), 4)
        dio.atomic_write(self.path, json.dumps(rec).encode("utf-8"),
                         member="lease")
        faults.slow_hold("fabric.lease", self.interval_s)

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self._orphan_check and os.getppid() != self._ppid:
                os._exit(EXIT_ORPHANED)
            self.beat_once()
            self._stop.wait(self.interval_s)

    def start(self) -> "HostLease":
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"fabric-lease-{self.host_id}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def run_worker(fabric_dir: str, host_id: str, *, build_entry, scheduler,
               config, on_result=None, lease_s: float = 5.0,
               preemption=None, poll_s: float = 0.05,
               status=None, alerts=None, devices: int | None = None) -> list:
    """Run one fabric worker to completion; returns the server's results.

    ``build_entry(user_id) -> FleetUser | None``: constructs the user's
    entry from its (possibly mid-run) workspace — a failed-over user
    resumes from whatever its dead host durably committed.  ``None``
    means the workspace is already complete; the worker journals the
    ``finish`` directly (with ``skipped=True``) so the coordinator
    resolves the user without burning a slot.  A raising ``build_entry``
    journals a FINAL ``fail`` for the same reason — the coordinator must
    never wait forever on a user no worker can construct.

    ``scheduler``: a fresh :class:`~consensus_entropy_tpu_torch.fleet.scheduler.
    FleetScheduler` built for serving (``scoring_by_width=True``).
    ``config``: the worker's :class:`~consensus_entropy_tpu_torch.serve.server.
    ServeConfig`.  ``lease_s``: the coordinator's lease — heartbeats run
    at a third of it so one missed beat never looks like death.
    ``devices``: chips this worker serves with, advertised in every
    heartbeat for devices-aware placement; defaults to the config's
    ``mesh_devices`` (1 when unsharded).
    """
    paths = fabric_paths(fabric_dir, host_id)
    journal = AdmissionJournal(paths["events"])
    # ``status``/``alerts``: the worker's live-introspection limbs (an
    # obs.status.StatusWriter; an obs.alerts.AlertWatcher)
    server = FleetServer(scheduler, config, preemption=preemption,
                         journal=journal, status=status, alerts=alerts)
    feed = JsonlTail(paths["assign"])
    gate = EpochGate()  # fencing-epoch latch over every feed line
    stop = threading.Event()
    # QueueFull-retry jitter stream, seeded per host (crc32, not hash():
    # stable across processes so a replayed fabric run backs off on the
    # same schedule on every host)
    retry_rng = np.random.default_rng(zlib.crc32(str(host_id).encode()))

    def intake():
        """Tail the assignment feed into the server's admission queue;
        runs as the 'threaded producer' the server's keep_open mode is
        built for.  Beyond user routings the feed carries the elastic
        control plane's lines: ``{"edges": [...]}`` (fleet-planner
        bucket edges — adopt for future admissions), ``{"drop": uid}``
        (rebalance withdrawal — journal an ACK saying whether the user
        was still queued here; the coordinator only moves it on a
        positive ack, so admission always wins the race),
        ``{"drain": true}`` (scale-down: stop admitting, shed users,
        exit clean) and ``{"fence": uid}`` (in-flight migration:
        release the user at its next checkpoint boundary and ack with
        the checkpoint generation — the coordinator commits the
        re-assign only on the journaled ack).  A drop carrying
        ``"evict": true`` is the fence's DEADLINE fallback: force-
        release the user at its next step boundary (evict+resume
        semantics) and ack as a ``drop`` — deferred when in-flight,
        exactly like a fence."""
        while not stop.is_set():
            for rec, _off in feed.poll():
                if not gate.admit(rec):
                    # a stale coordinator incarnation's line: journal
                    # the refusal (the coordinator transcribes it as an
                    # audit record + obs event) and act on NOTHING —
                    # routing, fences and withdrawals all belong to the
                    # incarnation whose epoch the gate has latched
                    stale = rec.get("user") or rec.get("drop") \
                        or rec.get("fence")
                    journal.append(
                        "epoch_fenced",
                        None if stale is None else str(stale),
                        epoch=int(rec["ep"]))
                    continue
                if gate.epoch is not None:
                    # the latched epoch rides on every DEFERRED ack the
                    # serve loop journals (fence/drop releases)
                    server.epoch = gate.epoch
                if rec.get("close"):
                    server.close_intake()
                    return
                if rec.get("drain"):
                    # scale-down sentinel: stop ADMITTING but keep
                    # consuming the feed — the coordinator still sends
                    # drop withdrawals and fence requests while this
                    # host sheds its users; the serve loop exits on its
                    # own once nothing queued or in-flight remains
                    server.close_intake()
                    continue
                if rec.get("fence") is not None:
                    # in-flight migration request: release the user at
                    # its next checkpoint boundary.  Queued/unknown
                    # verdicts ack immediately; an in-flight release
                    # acks from the serve loop with the checkpoint
                    # generation once the boundary commits
                    verdict = server.fence(rec["fence"])
                    if verdict is not None:
                        journal.append("fence", str(rec["fence"]),
                                       ok=bool(verdict),
                                       **server.ack_epoch())
                    continue
                if isinstance(rec.get("edges"), list):
                    try:
                        server.apply_fleet_edges(rec["edges"])
                    except (TypeError, ValueError):
                        pass  # malformed broadcast: keep local routing
                    continue
                if isinstance(rec.get("depth"), str):
                    # gray-ladder degradation dial: score with the
                    # cheap committee stage ("cheap") or restore
                    # ("full").  Telemetry-graded, never journaled —
                    # a malformed value keeps the current depth
                    try:
                        server.set_depth(rec["depth"])
                    except (AttributeError, ValueError):
                        pass
                    continue
                if rec.get("drop") is not None:
                    uid = str(rec["drop"])
                    if rec.get("evict"):
                        # deadline-fenced degradation: queued/unknown
                        # verdicts ack now; an in-flight force-release
                        # acks from the serve loop once the session's
                        # next ready pop releases it
                        verdict = server.evict(uid)
                        if verdict is not None:
                            journal.append("drop", uid, ok=bool(verdict),
                                           **server.ack_epoch())
                    else:
                        ok = server.withdraw(uid)
                        journal.append("drop", uid, ok=ok,
                                       **server.ack_epoch())
                    continue
                uid = rec.get("user")
                if uid is None:
                    continue
                try:
                    entry = build_entry(uid)
                except Exception as e:
                    journal.append("fail", uid, error=repr(e), final=True)
                    continue
                if entry is None:
                    # workspace already complete: resolve without a slot
                    journal.append("finish", uid, skipped=True)
                    continue
                if isinstance(rec.get("cls"), str):
                    # the coordinator routed the priority class along
                    # with the user (serve.planner classes)
                    entry.priority = rec["cls"]
                attempt = 0
                while not stop.is_set():
                    try:
                        server.submit(entry)
                        break
                    except QueueFull:
                        # backpressure: seeded-jitter exponential backoff
                        # (per-host stream) instead of a fixed period, so
                        # a fleet of saturated workers' producers don't
                        # re-poll the bound in lockstep
                        stop.wait(backoff_delay(attempt,
                                                base_delay=poll_s,
                                                max_delay=20 * poll_s,
                                                rng=retry_rng))
                        attempt += 1
                    except (QueueClosed, RuntimeError):
                        return  # draining: the rerun picks the user up
            stop.wait(poll_s)

    if devices is None:
        devices = int(getattr(config, "mesh_devices", 1) or 1)
    lease = HostLease(paths["lease"], host_id,
                      max(lease_s / 3.0, 0.05),
                      devices=devices,
                      step_source=lambda: getattr(
                          scheduler, "step_wall_ema", None)).start()
    thread = threading.Thread(target=intake, daemon=True,
                              name=f"fabric-intake-{host_id}")
    thread.start()
    try:
        return server.serve((), keep_open=True, on_result=on_result)
    finally:
        stop.set()
        thread.join(timeout=2.0)
        lease.stop()
        feed.close()
        journal.close()
