"""Preemption: finish the in-flight iteration, then exit clean.

Counterpart of ``consensus_entropy_tpu/resilience/preemption.py``.  The
SIGTERM/SIGINT handler only sets a flag; the loop checks it at iteration
boundaries, joins the in-flight checkpoint and raises :class:`Preempted`,
which the CLI turns into :data:`EXIT_PREEMPTED`.
"""

from __future__ import annotations

import signal
import threading

#: EX_TEMPFAIL: "run me again", distinct from an error exit.
EXIT_PREEMPTED = 75


class Preempted(BaseException):
    """Raised at an iteration boundary after the checkpoint is durable
    (a ``BaseException`` so quarantine and retry cannot absorb it)."""


class PreemptionGuard:
    """Context manager installing SIGTERM/SIGINT handlers that request a
    graceful stop; ``request()`` does the same from code.  Off the main
    thread only ``request()`` works."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._old: dict = {}
        self._event = threading.Event()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        self._event.set()

    def _handler(self, signum, frame):  # noqa: ARG002 (signal signature)
        self._event.set()

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            try:
                self._old[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc) -> None:
        for s, old in self._old.items():
            signal.signal(s, old)
        self._old.clear()
