"""Fleet throughput reporting: users/s, device-batch occupancy, phases.

Counterpart of ``consensus_entropy_tpu/fleet/report.py`` (``:43-446``).
Each session keeps its own per-user files; this adds the cohort's view:

- one ``fleet_metrics.jsonl`` event stream (dispatches are kept in memory;
  evictions, resumes, completions and failed stacked dispatches are
  events) written through ``obs.metrics.EventWriter``,
- a summary with users/s, device-batch occupancy (how full the stacked
  dispatches ran against the sessions holding a slot at that moment),
  per-bucket occupancy, the transfer and CNN-dispatch roll-ups and the
  sessions' summed phase times,
- a BENCH-shaped one-line JSON (:func:`bench_line`),
- under the serve layer, the admission telemetry: ``enqueue`` / ``admit``
  events, queue depth and wait, each user's first-enqueue-to-finish
  latency in a histogram (exact p50/p95/p99 while its reservoir holds),
  one such histogram a priority class, the SLO planner's section and the
  fault domain's counters (watchdog evictions, breaker trips, requeues,
  poisoned users).

Occupancy counts only ACTIVE slots: a finished, evicted or failed session
stops counting the moment its generator returned.  The port compiles
nothing at run time, so the summary has no ``jit`` section
(``obs.jit_telemetry``).
"""

from __future__ import annotations

import threading
import time

from consensus_entropy_tpu_torch.obs.metrics import (
    EventWriter,
    MetricsRegistry,
)

#: fn keys of the CNN device-plan dispatches, rolled up on their own
CNN_DISPATCH_FNS = ("cnn_probs", "qbdc_probs", "cnn_retrain", "cnn_eval")

#: summary counters of fault events, present only when nonzero
_FAULT_COUNTS = (("watchdog_evictions", "watchdog_evict"),
                 ("breaker_trips", "breaker_open"),
                 ("breaker_giveups", "breaker_giveup"),
                 ("dispatch_failures", "dispatch_failed"),
                 ("dispatch_session_errors", "dispatch_session_error"),
                 ("requeues", "requeue"),
                 ("users_poisoned", "poison"))


def _dispatch_rollup(ds: list[dict]) -> dict:
    """Dispatch count, mean batch and occupancy against the slots active
    at each dispatch."""
    per = [d["batch"] / d["active"] for d in ds if d["active"]]
    return {
        "dispatches": len(ds),
        "mean_batch": round(sum(d["batch"] for d in ds) / len(ds), 2)
        if ds else None,
        "occupancy": round(sum(per) / len(per), 3) if per else None,
    }


class FleetReport:
    """Collects a fleet run's telemetry; ``jsonl_path`` streams the events
    (``None`` keeps them in memory only).  Events may come from worker
    threads, so the stream is locked."""

    def __init__(self, jsonl_path: str | None = None):
        self.jsonl_path = jsonl_path
        self.dispatches: list[dict] = []
        self.events: list[dict] = []
        self.phase_totals: dict[str, float] = {}
        #: ``(label, t0_ns, t1_ns)`` of each pooled host step, unix-epoch
        #: ns: set beside a device trace, the share of device time that
        #: overlaps host work
        self.host_steps: list[tuple] = []
        self.users_done = 0
        self.users_failed = 0
        self.metrics = MetricsRegistry()
        #: host-clock seconds of each device dispatch (stacked or single)
        self.dispatch_wall = self.metrics.rolling("dispatch_wall_s")
        #: the serve layer's admission telemetry (empty outside serving)
        self.queue_depth = self.metrics.rolling("queue_depth")
        self.admission_wait = self.metrics.rolling("admission_wait_s")
        #: each user's first enqueue -> user_done or terminal failure (the
        #: queue wait included: what a latency SLO targets)
        self.admission_latency = self.metrics.histogram(
            "admission_to_finish_s")
        #: the same a priority class, made at the class's first admit
        self._class_latency: dict[str, object] = {}
        self._class_of: dict[str, str] = {}
        #: the SLO planner (``serve.planner``), installed by ``FleetServer``
        #: so the summary carries its section
        self.planner = None
        self._admit_t: dict[str, float] = {}
        self.writer = EventWriter(jsonl_path)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------

    def _emit(self, rec: dict) -> None:
        with self._lock:
            self.events.append(rec)
            self.writer.emit(rec)

    def dispatch(self, fn_key: str, batch: int, active: int,
                 wall_s: float, width: int | None = None,
                 h2d_bytes: int | None = None,
                 h2d_ops: int | None = None) -> None:
        """One device dispatch: ``batch`` sessions served together out of
        ``active`` live slots (this bucket's when ``width`` names one);
        ``h2d_bytes`` / ``h2d_ops``: host->device bytes and uploads it
        staged."""
        rec = {"fn": fn_key, "batch": batch, "active": active,
               "wall_s": wall_s}
        if width is not None:
            rec["width"] = width
        if h2d_bytes is not None:
            rec["h2d_bytes"] = h2d_bytes
        if h2d_ops is not None:
            rec["h2d_ops"] = h2d_ops
        self.dispatches.append(rec)
        self.dispatch_wall.add(wall_s)

    def host_step(self, label: str, t0_ns: int, t1_ns: int) -> None:
        """A pooled host step ran from ``t0_ns`` to ``t1_ns`` (a worker
        thread calls this)."""
        with self._lock:
            self.host_steps.append((label, t0_ns, t1_ns))

    def event(self, kind: str, /, **fields) -> None:
        """A cohort-level event (evict, resume, user_done, user_failed,
        dispatch_failed, ...)."""
        self._emit({"event": kind, "t_s": round(self.elapsed_s(), 3),
                    **fields})

    def enqueued(self, user, depth: int, cls: str = "batch") -> None:
        """A user entered the serve layer's waiting queue (``depth`` after
        it), in priority class ``cls``; producer threads call this too.
        The first enqueue starts the user's latency clock; a backoff
        re-enqueue continues it."""
        with self._lock:
            self.queue_depth.add(depth)
            self._admit_t.setdefault(str(user), time.perf_counter())
        self.event("enqueue", user=str(user), depth=depth, cls=cls)

    def admitted(self, user, *, width: int, wait_s: float, depth: int,
                 live: int, cls: str = "batch") -> None:
        """A queued user was admitted into the engine: its bucket width,
        class, queue wait, the depth left behind and the live sessions
        after it."""
        with self._lock:
            self.admission_wait.add(wait_s)
            self.queue_depth.add(depth)
            self._admit_t.setdefault(str(user), time.perf_counter())
            self._class_of.setdefault(str(user), cls)
            if cls not in self._class_latency:
                self._class_latency[cls] = self.metrics.histogram(
                    f"admission_to_finish_s.{cls}")
        self.event("admit", user=str(user), width=width,
                   wait_s=round(wait_s, 4), depth=depth, live=live,
                   cls=cls)

    def _finish_latency(self, user) -> None:
        with self._lock:
            t = self._admit_t.pop(str(user), None)
            if t is not None:
                latency = time.perf_counter() - t
                self.admission_latency.add(latency)
                cls = self._class_of.get(str(user))
                if cls in self._class_latency:
                    self._class_latency[cls].add(latency)

    def class_p95s(self) -> dict:
        """``{class: p95 of its admission-to-finish latency}`` (``None``
        before a class resolved anyone)."""
        with self._lock:
            return {cls: h.percentile(95)
                    for cls, h in self._class_latency.items()}

    def user_done(self, user, result: dict, phases: dict) -> None:
        """A session finished; ``phases`` are its summed ``{phase}_s``."""
        self.users_done += 1
        self._finish_latency(user)
        for k, v in phases.items():
            self.phase_totals[k] = self.phase_totals.get(k, 0.0) + v
        self.event("user_done", user=str(user),
                   final_mean_f1=result.get("final_mean_f1"),
                   epochs=len(result.get("trajectory", [])))

    def user_failed(self, user, error: str,
                    attempts: int | None = None) -> None:
        """A user failed terminally (its resumes, if any, spent, and under
        the serve layer its re-admissions)."""
        self.users_failed += 1
        self._finish_latency(user)
        rec = {"user": str(user), "error": error}
        if attempts is not None:
            rec["attempts"] = attempts
        self.event("user_failed", **rec)

    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0

    def count(self, kind: str) -> int:
        """How many events of ``kind`` were recorded."""
        return sum(e["event"] == kind for e in self.events)

    # -- summaries ---------------------------------------------------------

    @property
    def occupancy(self) -> float | None:
        """Mean served-sessions per dispatch over the slots active at that
        moment: 1.0 is every dispatch serving every active session."""
        return _dispatch_rollup(self.dispatches)["occupancy"]

    @property
    def per_bucket_occupancy(self) -> dict | None:
        """``{width: {"occupancy", "dispatches", "mean_batch"}}`` of the
        width-tagged dispatches; ``None`` when none was."""
        buckets: dict[int, list[dict]] = {}
        for d in self.dispatches:
            if "width" in d:
                buckets.setdefault(d["width"], []).append(d)
        if not buckets:
            return None
        return {w: _dispatch_rollup(ds) for w, ds in sorted(buckets.items())}

    @property
    def transfer_summary(self) -> dict | None:
        """Host->device traffic of the dispatches: bytes and uploads, in
        all and per select (a session-iteration of a reduction dispatch),
        and device calls per select (reduction dispatches plus uploads).
        ``None`` when no dispatch carried transfer accounting."""
        if not any("h2d_bytes" in d for d in self.dispatches):
            return None
        red = [d for d in self.dispatches
               if d["fn"] not in CNN_DISPATCH_FNS]
        selects = sum(d["batch"] for d in red)
        h2d = sum(d.get("h2d_bytes") or 0 for d in self.dispatches)
        ops = sum(d.get("h2d_ops") or 0 for d in self.dispatches)
        out = {"h2d_bytes": h2d, "h2d_ops": ops, "selects": selects}
        if selects:
            out["h2d_bytes_per_select"] = round(h2d / selects)
            out["h2d_ops_per_select"] = round(ops / selects, 3)
            out["device_calls_per_select"] = round(
                (len(red) + ops) / selects, 3)
        return out

    @property
    def cnn_dispatch_summary(self) -> dict | None:
        """The CNN plan dispatches per fn and combined (``mean_device_
        batch``, occupancy); ``None`` without CNN dispatches."""
        cnn = [d for d in self.dispatches if d["fn"] in CNN_DISPATCH_FNS]
        if not cnn:
            return None
        combined = _dispatch_rollup(cnn)
        out = {"dispatches": combined["dispatches"],
               "mean_device_batch": combined["mean_batch"]}
        if combined["occupancy"] is not None:
            out["occupancy"] = combined["occupancy"]
        for fn in CNN_DISPATCH_FNS:
            ds = [d for d in cnn if d["fn"] == fn]
            if ds:
                out[fn] = _dispatch_rollup(ds)
        return out

    def summary(self, *, cohort: int, wall_s: float | None = None) -> dict:
        """The cohort roll-up.  ``phase_wall_s`` sums the sessions' own
        timers (a phase spanning a scheduler hand-off includes its wait);
        ``dispatch_wall_s`` is the scheduler's device dispatch time
        alone."""
        wall = self.elapsed_s() if wall_s is None else wall_s
        batches = [d["batch"] for d in self.dispatches]
        out = {
            "cohort": cohort,
            "users_done": self.users_done,
            "users_failed": self.users_failed,
            "wall_s": round(wall, 3),
            "users_per_sec": round(self.users_done / wall, 4) if wall
            else None,
            "score_dispatches": len(batches),
            "dispatch_wall_s": round(self.dispatch_wall.total, 3),
            "mean_device_batch": round(sum(batches) / len(batches), 2)
            if batches else None,
            "occupancy": self.occupancy,
            "phase_wall_s": {k: round(v, 3)
                             for k, v in sorted(self.phase_totals.items())},
            "host_step_wall_s": round(sum(
                t1 - t0 for _, t0, t1 in self.host_steps) / 1e9, 3),
            "evictions": self.count("evict"),
            "resumes": self.count("resume"),
        }
        for key, kind in _FAULT_COUNTS:
            n = self.count(kind)
            if n:
                out[key] = n
        for key, value in (("per_bucket", self.per_bucket_occupancy),
                           ("cnn", self.cnn_dispatch_summary),
                           ("transfer", self.transfer_summary)):
            if value is not None:
                out[key] = value
        if self.admission_wait.n:
            out["admissions"] = self.admission_wait.n
            out["admission_wait_s"] = self.admission_wait.snapshot()
            out["queue_depth"] = self.queue_depth.snapshot()
        if self.admission_latency.n:
            out["admission_to_finish_s"] = self.admission_latency.snapshot()
        if self._class_latency:
            out["per_class"] = {}
            for cls, h in sorted(self._class_latency.items()):
                snap = h.snapshot()
                # resolved users (finished or failed), the histogram's n
                out["per_class"][cls] = {
                    "users": snap["n"] if snap else 0,
                    "admission_to_finish_s": snap}
        if self.planner is not None:
            out["planner"] = self.planner.summary()
        return out

    def write_summary(self, *, cohort: int,
                      wall_s: float | None = None) -> dict:
        """Emit the summary as the stream's last event and return it."""
        s = self.summary(cohort=cohort, wall_s=wall_s)
        self._emit({"event": "fleet_summary", **s})
        return s

    def close(self) -> None:
        self.writer.close()


def bench_line(summary: dict, *, baseline_users_per_sec: float | None = None,
               extra: dict | None = None) -> dict:
    """A fleet summary in the repo's BENCH line shape (``metric``,
    ``value``, ``unit``, ``vs_baseline``, ...)."""
    ups = summary.get("users_per_sec")
    line = {
        "metric": f"fleet_users_per_sec_n{summary.get('cohort')}",
        "value": ups,
        "unit": "users/s",
        "vs_baseline": (round(ups / baseline_users_per_sec, 2)
                        if ups and baseline_users_per_sec else None),
        "occupancy": summary.get("occupancy"),
        "users_done": summary.get("users_done"),
        "evictions": summary.get("evictions"),
        "phase_wall_s": summary.get("phase_wall_s"),
    }
    for key in ("per_bucket", "cnn", "transfer", "admission_to_finish_s",
                "per_class", "planner"):
        if summary.get(key) is not None:
            line[key] = summary[key]
    for key, _ in _FAULT_COUNTS:
        if summary.get(key):
            line[key] = summary[key]
    if extra:
        line.update(extra)
    return line
