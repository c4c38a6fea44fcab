"""The trace player: a threaded producer that replays a
:class:`~consensus_entropy_tpu_torch.workload.trace.Trace` against a
serving target through its enqueue and backpressure surface.

Counterpart of ``consensus_entropy_tpu/workload/driver.py``
(``:41-237``): ``ServerTarget`` plays into a ``FleetServer``,
``FabricTarget`` into a ``FabricCoordinator``.  The driver owns no policy; it adds the mechanics of a
well-behaved producer:

- **paced playback**: each event fires at ``t0 + event.t * time_scale``
  on the injected ``clock``/``sleep`` seam, so tests replay a trace
  compressed;
- **backoff on ``QueueFull``**: the shared seeded-jitter schedule
  (:func:`resilience.retry.backoff_delay`), every retry counted;
- **lifecycle verbs**: ``disconnect`` withdraws a still-queued user or
  evicts an in-flight one at its next step boundary (its workspace keeps
  its last committed generation); ``reconnect`` re-submits, which lands
  on the journal's re-admission path.

The driver thread builds each user's entry (``ServerTarget.build_entry``)
while the serve loop runs the engine on its own thread.  Both reach the
card through its default stream, which orders their work, so an entry
built here is complete before the engine's first call on it.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from consensus_entropy_tpu_torch.resilience.retry import backoff_delay
from consensus_entropy_tpu_torch.serve.server import QueueClosed, QueueFull


@dataclasses.dataclass
class DriverStats:
    """What playback actually did — the grader folds these into the
    ``measured`` section (retries ≈ how hard backpressure pushed back)."""

    submitted: int = 0
    #: arrivals abandoned because the target closed / refused for good
    rejected: int = 0
    queue_full_retries: int = 0
    disconnects: int = 0
    reconnects: int = 0
    #: events dropped because their user was already rejected
    skipped: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ServerTarget:
    """Adapt an in-process :class:`FleetServer` (serve the loop with
    ``keep_open=True``).  ``build_entry(uid, cls, pool)`` returns the
    FleetUser to submit (the caller binds its committee factory there);
    ``cls`` lands on ``entry.priority`` so the trace's class mix reaches
    the admission queue."""

    def __init__(self, server, build_entry):
        self.server = server
        self.build_entry = build_entry

    def submit(self, uid: str, *, cls: str, pool: int) -> None:
        entry = self.build_entry(uid, cls, pool)
        entry.priority = cls
        self.server.submit(entry)

    def disconnect(self, uid: str) -> None:
        # still queued -> clean withdraw; in flight -> evict (released at
        # the next step boundary, the workspace at its committed
        # generation: what a dropped connection leaves behind)
        if not self.server.withdraw(uid):
            self.server.evict(uid)

    def close(self) -> None:
        self.server.close_intake()


class FabricTarget:
    """Adapt a :class:`~consensus_entropy_tpu_torch.serve.fabric.
    FabricCoordinator` running with ``keep_open=True``: submissions land
    in the coordinator's bounded intake (the same ``QueueFull``
    backpressure), disconnects ride the journaled evict path."""

    def __init__(self, coordinator):
        self.coordinator = coordinator

    def submit(self, uid: str, *, cls: str, pool: int) -> None:
        self.coordinator.submit(uid, cls=cls, pool=pool)

    def disconnect(self, uid: str) -> None:
        self.coordinator.disconnect(uid)

    def close(self) -> None:
        self.coordinator.close_intake()


class TraceDriver:
    """Play ``trace`` against ``target``; one background thread, stats
    readable live (the soak's progress meter) and final.

    ``time_scale`` multiplies every trace offset (1.0 = wall time);
    ``clock``/``sleep`` are the injectable time seam; ``backoff_seed``
    seeds the ``QueueFull`` retry jitter so a replayed soak backs off on
    the same schedule; ``max_retry_s`` bounds how long one arrival keeps
    retrying before counting as rejected (None = until the queue closes).
    """

    def __init__(self, trace, target, *, time_scale: float = 1.0,
                 clock=time.monotonic, sleep=time.sleep,
                 backoff_seed: int = 0, base_delay: float = 0.05,
                 max_delay: float = 1.0, max_retry_s: float | None = None,
                 close_on_exhaust: bool = True):
        if time_scale <= 0:
            raise ValueError(f"time_scale must be > 0, got {time_scale}")
        self.trace = trace
        self.target = target
        self.time_scale = time_scale
        self._clock = clock
        self._sleep = sleep
        self._rng = np.random.default_rng(backoff_seed)
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.max_retry_s = max_retry_s
        self.close_on_exhaust = close_on_exhaust
        self.stats = DriverStats()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: users whose arrival was ultimately rejected — their later
        #: churn events are meaningless and skipped
        self._dead: set = set()

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "TraceDriver":
        """Begin playback on a daemon thread; returns self for
        ``driver.start().join()`` chains."""
        if self._thread is not None:
            raise RuntimeError("driver already started")
        self._thread = threading.Thread(
            target=self.run, name="trace-driver", daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: float | None = None) -> bool:
        """Wait for playback to finish; True when the thread is done."""
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def stop(self) -> None:
        """Abort playback (the remaining events are dropped); the
        in-progress backoff wakes at its next check."""
        self._stop.set()

    # -- playback -----------------------------------------------------

    def run(self) -> DriverStats:
        """Play every event at its scheduled offset (inline variant of
        :meth:`start` for single-threaded tests).  Events that fall
        behind schedule fire immediately — the driver never reorders."""
        t0 = self._clock()
        try:
            for ev in self.trace.events:
                if self._stop.is_set():
                    break
                due = t0 + ev["t"] * self.time_scale
                delay = due - self._clock()
                if delay > 0:
                    self._sleep(delay)
                self._dispatch(ev)
        finally:
            if self.close_on_exhaust and not self._stop.is_set():
                try:
                    self.target.close()
                except Exception:
                    pass
        return self.stats

    def _dispatch(self, ev: dict) -> None:
        kind, uid = ev["kind"], ev["user"]
        if uid in self._dead:
            with self._lock:
                self.stats.skipped += 1
            return
        if kind == "arrive":
            self._submit(uid, cls=ev["cls"], pool=ev["pool"])
        elif kind == "disconnect":
            try:
                self.target.disconnect(uid)
                with self._lock:
                    self.stats.disconnects += 1
            except Exception:
                self._dead.add(uid)
        else:  # reconnect: re-submit — the journal re-admission path
            if self._submit(uid, cls=ev.get("cls", "batch"),
                            pool=ev.get("pool", 0), reconnect=True):
                with self._lock:
                    self.stats.reconnects += 1

    def _submit(self, uid: str, *, cls: str, pool: int,
                reconnect: bool = False) -> bool:
        """Submit with jittered-backoff ``QueueFull`` retry.  Returns
        True on success; on terminal refusal the user is marked dead so
        its later churn events are skipped, not half-played."""
        attempt = 0
        t_first = self._clock()
        while not self._stop.is_set():
            try:
                self.target.submit(uid, cls=cls, pool=pool)
                with self._lock:
                    self.stats.submitted += 0 if reconnect else 1
                return True
            except QueueFull:
                if self.max_retry_s is not None \
                        and self._clock() - t_first >= self.max_retry_s:
                    break
                with self._lock:
                    self.stats.queue_full_retries += 1
                self._sleep(backoff_delay(
                    attempt, base_delay=self.base_delay,
                    max_delay=self.max_delay, rng=self._rng))
                attempt += 1
            except (QueueClosed, RuntimeError):
                break
        self._dead.add(uid)
        with self._lock:
            self.stats.rejected += 1
        return False
