"""Dispatch scopes and compile-event subscribers.

Counterpart of the scheduler-facing surface of
``consensus_entropy_tpu/obs/jit_telemetry.py`` (``subscribe``,
``unsubscribe``, ``dispatch_scope``, ``:65-110``).  The JAX package builds
jit families and XLA compiles them at first dispatch, and reports both as
``compile`` events.  The port compiles nothing at run time (its scorers
and CNN programs are eager PyTorch; its one CUDA kernel is built once per
checkout by ``kernels/build.py``), so this module emits NO compile events:
a subscriber is registered and never called, and ``FleetReport`` leaves
its ``jit`` section absent rather than report zero compiles as a
measurement.  ``dispatch_scope`` marks where the scheduler's dispatches
run, the seam a compile feed would attribute to; it records nothing.
"""

from __future__ import annotations

import contextlib
import threading

_LOCK = threading.Lock()
_LISTENERS: list = []


def subscribe(listener) -> None:
    """Register a listener for compile events (idempotent)."""
    with _LOCK:
        if listener not in _LISTENERS:
            _LISTENERS.append(listener)


def unsubscribe(listener) -> None:
    with _LOCK:
        if listener in _LISTENERS:
            _LISTENERS.remove(listener)


@contextlib.contextmanager
def dispatch_scope(fn: str, width=None, n_devices=None):
    """The dispatch of the ``(fn, width, n_devices)`` family runs inside:
    no compile can land in it, so nothing is recorded."""
    yield


def note_lookup(family: str, **key) -> None:
    """A family lookup keyed by ``(family, width, n_devices)``: nothing is
    compiled behind it, so nothing is recorded."""


def note_build(family: str, **key) -> None:
    """A family build: eager PyTorch builds no program, so nothing is
    recorded."""
