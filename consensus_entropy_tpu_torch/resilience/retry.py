"""Bounded retry with seeded, jittered exponential backoff.

Counterpart of ``consensus_entropy_tpu/resilience/retry.py``.  Only the
port's own :class:`~consensus_entropy_tpu_torch.resilience.faults.
TransientFault` is retried by default: a CUDA error is not a transient RPC
hiccup, so it propagates.
"""

from __future__ import annotations

import time
from typing import Callable, TypeVar

import numpy as np

from consensus_entropy_tpu_torch.resilience.faults import TransientFault

T = TypeVar("T")

TRANSIENT_ERRORS: tuple = (TransientFault,)


def backoff_delay(attempt: int, *, base_delay: float = 0.05,
                  max_delay: float = 2.0, rng=None) -> float:
    """``min(max_delay, base_delay * 2**attempt)``, jittered into
    ``[0.5, 1.5)x`` when ``rng`` is given."""
    delay = min(max_delay, base_delay * (2 ** max(attempt, 0)))
    if rng is not None:
        delay *= 0.5 + rng.random()
    return delay


def retry_transient(fn: Callable[[], T], *, attempts: int = 3,
                    base_delay: float = 0.05, max_delay: float = 2.0,
                    seed: int = 0, what: str = "op",
                    on: tuple | None = None,
                    sleep: Callable[[float], None] = time.sleep) -> T:
    """Call ``fn`` up to ``attempts`` times, sleeping the seeded backoff
    between tries; only errors in ``on`` (default :data:`TRANSIENT_ERRORS`)
    are retried, and the last one re-raises.  ``fn`` must be safe to call
    again.  ``what`` names the call site for the caller's logs."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    on = TRANSIENT_ERRORS if on is None else on
    rng = np.random.default_rng(seed)
    for attempt in range(attempts):
        try:
            return fn()
        except on:
            if attempt == attempts - 1:
                raise
            sleep(backoff_delay(attempt, base_delay=base_delay,
                                max_delay=max_delay, rng=rng))
    raise AssertionError("unreachable")  # pragma: no cover
