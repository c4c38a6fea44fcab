"""The session watchdog: wall-clock deadlines on every engine step.

Counterpart of ``consensus_entropy_tpu/serve/watchdog.py`` (``:38-120``).
A hung step (a host fit stuck in a pathological solve, checkpoint I/O
wedged on a dead mount, a device dispatch that never returns) would hold
its engine slot forever.  The watchdog bounds every step:

- **host steps**: the scheduler arms a per-session deadline when it
  submits a ``HostStep`` to the worker pool and reaps expired sessions at
  each pump: the future is abandoned (a thread cannot be killed; the
  zombie runs on against the discarded session's objects) and a
  :class:`WatchdogTimeout` is thrown into the session generator, whose
  own error path runs and whose user the eviction machinery resumes from
  its workspace;
- **device dispatches**: :meth:`Watchdog.call` runs the dispatch on a
  daemon thread and joins it with the deadline; expiry raises
  :class:`WatchdogTimeout` at the dispatch site.  CUDA work launched from
  that thread goes to the same device and the same default stream as the
  engine's, so the dispatch's results are ordered as inline ones are.

A zombie stuck forever keeps its pool thread until the process exits
(and, for a GBDT step, the OpenMP team the host core capped for that
worker), so the deadline belongs well above any real step time: it is a
tripwire, not a scheduler.
"""

from __future__ import annotations

import threading
import time


class WatchdogTimeout(RuntimeError):
    """A step exceeded its wall-clock deadline.  Derives from ``Exception``
    (unlike ``InjectedKill``/``Preempted``) ON PURPOSE: the eviction
    machinery is expected to absorb it and resume the session."""


class Watchdog:
    """Deadline bookkeeping for engine steps.

    ``deadline_s``: per-step wall-clock budget.  ``clock``: injectable
    monotonic source (tests).  ``trips`` counts every expiry (armed reaps
    and :meth:`call` timeouts) for telemetry."""

    def __init__(self, deadline_s: float, *, clock=time.monotonic):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self._clock = clock
        self._armed: dict = {}  # key -> (t_start, label)
        self.trips = 0

    # -- armed deadlines (host steps) --------------------------------------

    def arm(self, key, label: str = "") -> None:
        self._armed[key] = (self._clock(), label)

    def disarm(self, key) -> None:
        self._armed.pop(key, None)

    def expired(self) -> list:
        """``[(key, label, elapsed_s), ...]`` for every armed key past its
        deadline.  The caller disarms (or :meth:`trip`-s) what it reaps."""
        now = self._clock()
        return [(k, label, now - t0) for k, (t0, label) in
                list(self._armed.items()) if now - t0 > self.deadline_s]

    def trip(self, key, label: str, elapsed_s: float) -> WatchdogTimeout:
        """Disarm ``key``, count the trip, and return the exception to
        throw into the session's generator."""
        self.disarm(key)
        self.trips += 1
        return WatchdogTimeout(
            f"watchdog: step {label or 'host'!r} exceeded "
            f"{self.deadline_s:.3g}s deadline ({elapsed_s:.3g}s elapsed)")

    def poll_s(self) -> float:
        """How long a blocking wait may sleep before the next armed
        deadline could expire — keeps ``FleetScheduler._drain_host`` from
        blocking past a hung future.  Floor of 10 ms so an almost-expired
        deadline cannot spin the scheduler."""
        if not self._armed:
            return self.deadline_s
        now = self._clock()
        soonest = min(t0 + self.deadline_s - now
                      for t0, _ in self._armed.values())
        return max(0.01, min(soonest, self.deadline_s))

    # -- synchronous calls (device dispatches) -----------------------------

    def call(self, fn, what: str):
        """Run ``fn()`` under the deadline: executed on a daemon thread,
        joined with ``deadline_s``.  On expiry the thread is abandoned
        (see module docstring) and :class:`WatchdogTimeout` raises at the
        call site; an error from ``fn`` re-raises unchanged."""
        box: dict = {}

        def run():
            try:
                box["value"] = fn()
            except BaseException as e:  # incl. InjectedKill: re-raised below
                box["error"] = e

        t = threading.Thread(target=run, daemon=True,
                             name=f"watchdog-{what}")
        t.start()
        t.join(self.deadline_s)
        if t.is_alive():
            self.trips += 1
            raise WatchdogTimeout(
                f"watchdog: {what} exceeded {self.deadline_s:.3g}s deadline")
        if "error" in box:
            raise box["error"]
        return box["value"]
