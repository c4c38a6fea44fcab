"""The null span tracer.

Counterpart of ``NULL_TRACER`` in ``consensus_entropy_tpu/obs/trace.py``
(``:346``, a disabled ``Tracer``): the surface the fleet scheduler calls
(``enabled``, ``span``, ``span_at``, ``close_user``, ``run_ctx``), every
call a no-op.  The span tracer itself comes with the serving layer
(ROADMAP A10).
"""

from __future__ import annotations

import contextlib


class _NullTracer:
    enabled = False
    run_ctx = None

    @contextlib.contextmanager
    def span(self, name: str, *, parent=None, key=None, **attrs):
        yield None

    def span_at(self, name: str, t0: float, t1: float, *, parent=None,
                key=None, **attrs) -> None:
        return None

    def close_user(self, user, **attrs) -> None:
        return None


NULL_TRACER = _NullTracer()
