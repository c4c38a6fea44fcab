"""Span tracing with explicit contexts and deterministic ids, and the
device profiler's capture.

Counterpart of ``consensus_entropy_tpu/obs/trace.py`` (``:46-359``).  The
span hierarchy mirrors the serving stack::

    run ── user ── al_iter ── {host_step, checkpoint, member.update}
     │      └──── admission_wait            (serve: enqueue -> admit)
     ├──── {score_dispatch, retrain}        (stacked: one span, N users)
     │                └──── retrain.fit ── retrain.read
     ├──── host_wait                        (the pump blocked on host steps)
     └──── ctl.*                            (control decisions)

``retrain.fit`` is one member fit of one user, under its stacked
``retrain`` dispatch; a user's own retrain (a dispatch of one, inline or
sequential) parents its fits under the iteration, as a host update does
its ``member.update`` spans (they run inside the iteration's
``host_step``).

Trace ids derive from ``(run_id, user)`` and the user and iteration span
ids from ``(run_id, user, iteration)``, the same SHA-1 digests as the JAX
package's, so a session rebuilt after an eviction or a journal restart
continues its trace: the resumed attempt writes the same span ids for the
re-run iteration and the merge (``obs.export.load_spans``) keeps one.  An
iteration interrupted mid-flight leaves its span unwritten, and its
written children name a parent the resumed attempt writes, so a merged
trace has no orphans.

Contexts are explicit (``parent=``), never thread-local: the fleet
scheduler runs one session's host steps on worker threads while its
generator is suspended.  The sink is :class:`~obs.metrics.EventWriter`
(thread-safe, flushed per record, torn tails skipped by the readers).
``enabled=False`` (``--no-trace``) makes every call a no-op.

``thread_cpu=True`` on :meth:`Tracer.begin` / :meth:`Tracer.span` adds
``cpu_s``: the opening thread's CPU time (``time.thread_time``) from start
to end, written only when the same thread ends the span.  Beside the wall
clock's ``dur_s`` it tells a thread that ran from one that waited (for
the interpreter lock, the OS or the device).

:func:`device_trace` and :class:`DeviceProfile` take the place of
``jax.profiler``: a ``torch.profiler`` capture with CUDA activity (CPU
activity only when the device is the CPU), exported as Chrome trace JSON.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import os
import threading
import time

from consensus_entropy_tpu_torch.obs.metrics import EventWriter


def _digest(*parts) -> str:
    h = hashlib.sha1("\x1f".join(str(p) for p in parts).encode("utf-8"))
    return h.hexdigest()[:16]


def trace_id(run_id: str, user=None) -> str:
    """The deterministic trace id of (run, user), or of the run itself
    when ``user`` is None."""
    return _digest("trace", run_id) if user is None \
        else _digest("trace", run_id, str(user))


class SpanContext:
    """An addressable span: the ``(trace, span)`` id pair passed as
    ``parent=`` to child spans."""

    __slots__ = ("trace", "span")

    def __init__(self, trace: str, span: str):
        self.trace = trace
        self.span = span

    def __repr__(self):
        return f"SpanContext({self.trace}/{self.span})"


class _OpenSpan:
    """Handle of :meth:`Tracer.begin`; usable as ``parent=`` itself."""

    __slots__ = ("ctx", "name", "t0", "attrs", "cpu0", "thread")

    def __init__(self, ctx: SpanContext, name: str, t0: float, attrs: dict):
        self.ctx = ctx
        self.name = name
        self.t0 = t0
        self.attrs = attrs
        #: the opening thread's ``time.thread_time()`` and id, with
        #: ``thread_cpu``
        self.cpu0 = self.thread = None


def _ctx_of(parent) -> SpanContext | None:
    if parent is None:
        return None
    return parent.ctx if isinstance(parent, _OpenSpan) else parent


class Tracer:
    """Spans to a JSONL sink (``spans.jsonl``).

    ``run_id``: the run's deterministic identity (the CLI derives it from
    mode and seed, so a restarted run continues the same traces).
    ``host``: a lane tag.  ``path=None`` keeps spans in memory
    (``records``); ``enabled=False`` is the ``--no-trace`` arm."""

    def __init__(self, path: str | None = None, *, run_id: str = "run",
                 host: str | None = None, enabled: bool = True):
        self.enabled = enabled
        self.run_id = run_id
        self.host = host
        #: in-memory mirror, kept only without a sink
        self.records: list[dict] = []
        self._keep_records = path is None
        #: seconds spent inside the tracer, summed across threads (the
        #: instrumentation's cost; unlocked, so a few microseconds may drop)
        self.cost_s = 0.0
        self._writer = EventWriter(path if enabled else None)
        self._lock = threading.Lock()
        self._auto = 0
        #: open user root spans: span id -> (ctx, t0, attrs); the earliest
        #: open wins (serve opens the root at first enqueue)
        self._open_users: dict[str, tuple] = {}
        self.run_ctx = SpanContext(trace_id(run_id),
                                   _digest("span", run_id, "run"))
        self._run_t0 = time.time()

    # -- ids ---------------------------------------------------------------

    def user_ctx(self, user) -> SpanContext | None:
        """The user root's context, derivable without a session (serve
        parents ``admission_wait`` under it before one exists)."""
        if not self.enabled:
            return None
        return SpanContext(trace_id(self.run_id, user),
                           _digest("span", self.run_id, "user", str(user)))

    def _child_ctx(self, name: str, parent: SpanContext | None,
                   key) -> SpanContext:
        trace = parent.trace if parent is not None else self.run_ctx.trace
        if key is None:
            # a run-scoped span nobody replays (a stacked dispatch): unique
            # within and across runs, salted by host and the start instant
            with self._lock:
                self._auto += 1
                key = f"auto:{self.host}:{self._run_t0:.6f}:{self._auto}"
        return SpanContext(trace, _digest("span", self.run_id, name, key))

    # -- emission ----------------------------------------------------------

    def _emit(self, rec: dict) -> None:
        if self._keep_records:
            self.records.append(rec)
        self._writer.emit(rec)

    def _span_rec(self, ctx: SpanContext, parent: SpanContext | None,
                  name: str, t0: float, t1: float, attrs: dict) -> dict:
        rec = {"ev": "span", "trace": ctx.trace, "span": ctx.span,
               "parent": parent.span if parent is not None else None,
               "name": name, "t0": round(t0, 6),
               "dur_s": round(max(t1 - t0, 0.0), 6)}
        if self.host is not None:
            rec["host"] = self.host
        rec.update(attrs)
        return rec

    # -- spans -------------------------------------------------------------

    def begin(self, name: str, *, parent=None, key=None,
              thread_cpu: bool = False, **attrs) -> _OpenSpan | None:
        """Open a span without a context manager (a generator suspends
        across it); one never ended is never written.  ``thread_cpu``:
        record its ``cpu_s`` (module docstring)."""
        if not self.enabled:
            return None
        c0 = time.perf_counter()
        parent = _ctx_of(parent)
        ctx = self._child_ctx(name, parent, key)
        sp = _OpenSpan(ctx, name, time.time(), attrs)
        sp.attrs["_parent"] = parent
        if thread_cpu:
            # read after the wall clock's start, so it lies inside it
            sp.thread = threading.get_ident()
            sp.cpu0 = time.thread_time()
        self.cost_s += time.perf_counter() - c0
        return sp

    def end(self, span: _OpenSpan | None, **attrs) -> None:
        if span is None or not self.enabled:
            return
        c0 = time.perf_counter()
        cpu_s = (time.thread_time() - span.cpu0
                 if span.cpu0 is not None
                 and span.thread == threading.get_ident() else None)
        a = dict(span.attrs)
        parent = a.pop("_parent", None)
        a.update(attrs)
        if cpu_s is not None:
            a["cpu_s"] = round(cpu_s, 6)
        self._emit(self._span_rec(span.ctx, parent, span.name, span.t0,
                                  time.time(), a))
        self.cost_s += time.perf_counter() - c0

    @contextlib.contextmanager
    def span(self, name: str, *, parent=None, key=None,
             thread_cpu: bool = False, **attrs):
        """A span around the block; yields its :class:`SpanContext`.
        Written on exit, exceptions included."""
        if not self.enabled:
            yield None
            return
        sp = self.begin(name, parent=parent, key=key, thread_cpu=thread_cpu,
                        **attrs)
        try:
            yield sp.ctx
        finally:
            self.end(sp)

    def span_at(self, name: str, t0: float, t1: float, *, parent=None,
                key=None, **attrs) -> None:
        """A span from measured wall-clock endpoints."""
        if not self.enabled:
            return
        c0 = time.perf_counter()
        parent = _ctx_of(parent)
        ctx = self._child_ctx(name, parent, key)
        self._emit(self._span_rec(ctx, parent, name, t0, t1, attrs))
        self.cost_s += time.perf_counter() - c0

    # -- user roots --------------------------------------------------------

    def open_user(self, user, *, t0: float | None = None, **attrs) -> None:
        """Open the user's root span once (later opens keep the first
        ``t0``)."""
        if not self.enabled:
            return
        c0 = time.perf_counter()
        ctx = self.user_ctx(user)
        with self._lock:
            if ctx.span not in self._open_users:
                self._open_users[ctx.span] = (
                    ctx, time.time() if t0 is None else t0,
                    {"user": str(user), **attrs})
        self.cost_s += time.perf_counter() - c0

    def user_open_t0(self, user) -> float | None:
        """The open root's start time (None when not open)."""
        if not self.enabled:
            return None
        ctx = self.user_ctx(user)
        with self._lock:
            rec = self._open_users.get(ctx.span)
        return rec[1] if rec is not None else None

    def close_user(self, user, **attrs) -> None:
        """Write the user's root span (a no-op when it is not open)."""
        if not self.enabled:
            return
        c0 = time.perf_counter()
        ctx = self.user_ctx(user)
        with self._lock:
            open_rec = self._open_users.pop(ctx.span, None)
        if open_rec is not None:
            _ctx, t0, a = open_rec
            a.update(attrs)
            self._emit(self._span_rec(ctx, self.run_ctx, "user", t0,
                                      time.time(), a))
        self.cost_s += time.perf_counter() - c0

    # -- the control lane --------------------------------------------------

    def control_event(self, name: str, *, key, flow_user=None,
                      **attrs) -> None:
        """One control decision as an instant span (``ctl.*`` names,
        ``ctl: True``).  ``key`` is the decision's durable identity (the
        journal seq it was observed at), so a restart re-emits the same
        id and the merge keeps one; ``flow_user`` names the user it acts
        on (the Chrome export draws an arrow to that user's trace)."""
        if not self.enabled:
            return
        c0 = time.perf_counter()
        key = key if isinstance(key, tuple) else (key,)
        a = {"ctl": True}
        if flow_user is not None:
            a["flow_user"] = str(flow_user)
        a.update(attrs)
        now = time.time()
        ctx = self._child_ctx(name, self.run_ctx, ("ctl", name) + key)
        self._emit(self._span_rec(ctx, self.run_ctx, name, now, now, a))
        self.cost_s += time.perf_counter() - c0

    # -- lifecycle ---------------------------------------------------------

    def transcribe(self, rec: dict, *, host: str | None = None) -> None:
        """Re-emit a span record tailed from a worker's span WAL into this
        tracer's sink (the fabric coordinator merging worker spans as it
        transcribes event WALs).  At-least-once is fine: ids are
        deterministic and the merge dedupes."""
        if not self.enabled or rec.get("ev") != "span":
            return
        rec = dict(rec)
        if host is not None and "host" not in rec:
            rec["host"] = host
        self._emit(rec)

    def close(self, **attrs) -> None:
        """Write the run span and any still-open user roots (flagged
        ``open``), then close the sink."""
        if self.enabled:
            with self._lock:
                leftovers = list(self._open_users.items())
                self._open_users.clear()
            for _sid, (ctx, t0, a) in leftovers:
                self._emit(self._span_rec(ctx, self.run_ctx, "user", t0,
                                          time.time(),
                                          {**a, "open": True}))
            self._emit(self._span_rec(
                self.run_ctx, None, "run", self._run_t0, time.time(),
                {"run_id": self.run_id, **attrs}))
        self._writer.close()

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


#: the shared no-op tracer (``--no-trace``, sequential drivers)
NULL_TRACER = Tracer(None, enabled=False)

_captures = itertools.count()


class DeviceProfile:
    """One ``torch.profiler`` capture into ``trace_dir``: CUDA activity on
    a card (with the CPU's, so kernels show beside the calls that launched
    them), CPU activity only when ``device`` is the CPU.  :meth:`stop`
    exports the Chrome trace and returns its path."""

    def __init__(self, trace_dir: str, device):
        from torch.profiler import ProfilerActivity, profile

        self.trace_dir = trace_dir
        on_cpu = str(device).startswith("cpu")
        acts = [ProfilerActivity.CPU] if on_cpu else [
            ProfilerActivity.CPU, ProfilerActivity.CUDA]
        self._prof = profile(activities=acts)
        self.path: str | None = None

    def start(self) -> None:
        os.makedirs(self.trace_dir, exist_ok=True)
        self._prof.start()

    def stop(self) -> str:
        self._prof.stop()
        self.path = os.path.join(
            self.trace_dir,
            f"device_trace_{os.getpid()}_{next(_captures)}.json")
        self._prof.export_chrome_trace(self.path)
        return self.path


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device=None):
    """A :class:`DeviceProfile` around the block when a directory is
    given; a no-op otherwise."""
    if not trace_dir:
        yield
        return
    prof = DeviceProfile(trace_dir, "cuda" if device is None else device)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
