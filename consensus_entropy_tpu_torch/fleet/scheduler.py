"""Multi-user AL scheduling: N concurrent sessions, one device batch.

Counterpart of ``consensus_entropy_tpu/fleet/scheduler.py`` (``:83-1192``).
The scheduler drives N ``UserSession`` generators (``fleet.session``):

- **Stacked scoring**: sessions waiting on a ``ScoreStep`` are grouped by
  (scorer, input shapes) and each group of two or more runs as ONE call of
  the fleet scorers (``ops.scoring.make_fleet_scoring_fns``); each session
  gets its row, which is its own single call's.  A group of one takes the
  session's own scorer, the sequential path itself.
- **Stacked CNN device work**: sessions waiting on a ``DeviceStep`` are
  grouped by ``plan.group_key()`` and each group runs as one stacked
  dispatch (``models.committee.stage_device_plans`` then
  ``commit_device_plans``).  ``stack_cnn=False`` keeps the CNN work
  inline; ``plan_chunk`` serves plan groups in chunks of at most that many
  users, holding a partial chunk back while host steps are in flight.
- **Host/device overlap**: ``HostStep`` blocks (host member predicts,
  updates, evaluation, checkpoint boundaries; numpy in and out) run on a
  bounded worker pool while other sessions' device work is dispatched.
  Each worker caps the GBDT core's OpenMP team at its share of the cores.
- **Isolation**: each session keeps its workspace, report, quarantine
  ledger and checkpointer (backed by one shared, bounded executor).  A
  session that raises is EVICTED through its own error path and, with a
  ``committee_factory``, resumed from its workspace at the width it was
  admitted at; without one it fails alone.  A failed stacked dispatch is
  recorded (``dispatch_failed``) and its group served one session at a
  time.  ``Preempted`` / ``InjectedKill`` are ``BaseException``: they stop
  the whole fleet after every other generator is closed, so every
  workspace stays durable and resumable.

Each user's trajectory comes from the same statements in the same per-user
order as ``ALLoop.run_user``; scheduling only changes when each step runs.

:meth:`FleetScheduler.run` composes the lifecycle methods :meth:`open`,
:meth:`admit`, :meth:`pump` and :meth:`close` (:meth:`abort` on the error
path), public for a caller that holds the engine open.  With a pool-axis
``mesh`` every group runs through the sharded per-width families
(``parallel.pool_mesh.sharded_fleet_fns_for_width``): the stacked
``(U, M, N, C)`` is split on N, users times shards in one dispatch.

The serving layer's hooks (JAX ``scheduler.py:155-263``): ``watchdog``
bounds every host step and device dispatch (a hung host step's session is
evicted, ``_reap_hung_hosts``; teardown stays bounded); ``breaker``
degrades a width whose stacked dispatches keep failing to per-user
dispatch; ``hold`` sizes how long a partly formed stacked dispatch waits
for host steps in flight; ``on_terminal`` lets the server take a failed
user back for backoff re-admission; ``tracer`` writes the dispatch and
host-step spans, a stacked retrain's fits' spans under its dispatch's,
and a ``host_wait`` span wherever the pump blocks on host steps;
``profile_dir`` captures the first ``profile_n`` device
dispatches with ``torch.profiler``.  The fabric's release hooks (JAX
``scheduler.py:659-702``): ``request_release`` closes a session at its
next checkpoint boundary, ``force_release`` at its next step,
``take_released`` hands the released users with their checkpoint
generation to the server; ``step_wall_ema`` is the dispatch-wall EMA a
fabric worker's heartbeat carries.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable

import numpy as np
import torch

from consensus_entropy_tpu_torch import native
from consensus_entropy_tpu_torch.config import ALConfig
from consensus_entropy_tpu_torch.device import resolve_device
from consensus_entropy_tpu_torch.fleet.report import FleetReport
from consensus_entropy_tpu_torch.fleet.session import (
    DeviceStep,
    ScoreStep,
    UserSession,
)
from consensus_entropy_tpu_torch.models import committee as committee_mod
from consensus_entropy_tpu_torch.obs.metrics import StepTimer
from consensus_entropy_tpu_torch.obs.trace import NULL_TRACER, DeviceProfile
from consensus_entropy_tpu_torch.ops import scoring as ops_scoring
from consensus_entropy_tpu_torch.parallel.mesh import ShardedRows
from consensus_entropy_tpu_torch.resilience import faults


@dataclasses.dataclass
class FleetUser:
    """One cohort member.  ``committee_factory`` (nullary, reloads the
    committee from ``user_path``) enables resume after an eviction;
    without it a faulted user fails terminally."""

    user_id: object
    committee: object
    data: object  # al.loop.UserData
    user_path: str
    seed: int | None = None
    committee_factory: Callable | None = None
    #: the serve layer's admission priority class
    #: (``serve.planner.PRIORITY_CLASSES``); ignored outside serving
    priority: str = "batch"


@dataclasses.dataclass(eq=False)  # identity hash: states live in dicts
class _SessionState:
    entry: FleetUser
    session: UserSession
    gen: object
    #: the ``pad_pool_to`` this user was admitted at, for the whole run
    pad: int | None = None
    #: the acquirer's padded width, the dispatch bucket of its steps
    n_pad: int = 0
    started: bool = False
    resumes: int = 0
    #: fence mark (:meth:`FleetScheduler.request_release`): release at the
    #: next completed checkpoint boundary
    release: bool = False
    #: the deadline fallback's mark (:meth:`FleetScheduler.
    #: force_release`): release at the next ready pop, any step boundary
    force_release: bool = False
    #: label of the host step that just completed (``"checkpoint"`` is
    #: the release point of a fence-marked session)
    last_label: str | None = None


class FleetScheduler:
    """Run a cohort of user AL sessions concurrently on ``device`` (``None``
    is the card).

    ``host_workers``: the bounded pool for host steps (default
    ``min(cohort, cpus, 8)``).  ``pad_pool_to``: one pool width for the
    cohort (default its largest pool), so every session's scoring inputs
    share a shape.  ``scoring_by_width``: route stacked groups through the
    width-guarded families (``ops.scoring.fleet_scoring_fns_for_width``)
    and grade each dispatch against its own bucket, for a caller that
    admits users at several widths.  ``stack_cnn``, ``plan_chunk``,
    ``fuse_step``: see the module docstring and ``Acquirer``.  Each
    session writes its ``timings.jsonl``; a faulted user is resumed at
    most ``MAX_RESUMES`` times.  ``mesh``: a pool-axis mesh every
    session's pool is split across (its first device stands for
    ``device``); groups dispatch through the sharded families.

    ``batch_window_s``: before dispatching a partly full round while host
    steps are in flight, wait up to this long for more sessions to join
    (0: eager).  Serving hooks (module docstring): ``watchdog`` (a
    ``serve.watchdog.Watchdog``), ``breaker`` (a ``serve.breaker.
    DispatchBreaker``), ``on_terminal(entry, error, resumes)`` (True
    takes the failure over: no result is recorded), ``hold`` (an object
    whose ``window_s(waiting, host_in_flight)`` is the dispatch hold and
    whose optional ``note_host_step(seconds)`` learns host-step times),
    ``tracer`` (an ``obs.trace.Tracer``), ``profile_dir`` /
    ``profile_n``."""

    #: eviction -> resume attempts per user before it fails terminally
    MAX_RESUMES = 1
    #: the shared checkpoint pool's workers, at most
    CKPT_WORKERS = 4

    def __init__(self, config: ALConfig, *, tie_break: str = "fast",
                 retrain_epochs: int | None = None,
                 host_workers: int | None = None,
                 pad_pool_to: int | None = None, preemption=None,
                 report: FleetReport | None = None,
                 scoring_by_width: bool = False, stack_cnn: bool = True,
                 plan_chunk: int | None = None, fuse_step: bool = True,
                 device=None, mesh=None, batch_window_s: float = 0.0,
                 watchdog=None, breaker=None, on_terminal=None, hold=None,
                 tracer=None,
                 profile_dir: str | None = None, profile_n: int = 10):
        self.config = config
        self.mesh = mesh
        self.device = (mesh.device_list[0] if mesh is not None
                       and device is None else resolve_device(device))
        self.tie_break = tie_break
        self.retrain_epochs = retrain_epochs
        self.host_workers = host_workers
        self.pad_pool_to = pad_pool_to
        self.preemption = preemption
        self.report = report or FleetReport()
        self.scoring_by_width = scoring_by_width
        self.stack_cnn = stack_cnn
        self.plan_chunk = plan_chunk
        self.fuse_step = fuse_step
        self.batch_window_s = batch_window_s
        self.watchdog = watchdog
        self.breaker = breaker
        self.on_terminal = on_terminal
        self.hold = hold
        self.tracer = NULL_TRACER if tracer is None else tracer
        #: the device profiler's capture: started at the first device
        #: dispatch, stopped after ``profile_n`` of them (the Chrome trace
        #: lands in ``profile_dir``; its path in ``profile_path``)
        self._profile_dir = profile_dir
        self._profile_left = profile_n if profile_dir else 0
        self._profile: DeviceProfile | None = None
        self.profile_path: str | None = None
        #: ``"full"`` or ``"cheap"`` (each committee capped at its
        #: ``min_members`` floor): see :meth:`set_depth`
        self.depth = "full"
        #: EMA of recent device-dispatch walls (seconds): the gray
        #: detector's per-host signal, carried by a fabric worker's lease
        #: heartbeats.  Telemetry only; ``None`` until the first dispatch
        self.step_wall_ema: float | None = None
        self._opened = False

    # -- engine lifecycle --------------------------------------------------

    def open(self, capacity: int) -> None:
        """Stand the engine up for up to ``capacity`` live sessions: the
        worker pools, the queues, the results map."""
        if self._opened:
            raise RuntimeError("engine already open")
        capacity = max(1, capacity)
        cpus = os.cpu_count() or 4
        host_n = self.host_workers or min(capacity, cpus, 8)
        ckpt_n = min(capacity, self.CKPT_WORKERS)
        # a mesh engine dispatches through the sharded per-width families
        self._fleet_fns = None if self.mesh is not None else \
            ops_scoring.make_fleet_scoring_fns(
                k=self.config.queries, tie_break=self.tie_break)
        self._results: dict = {}
        # each host worker's GBDT fits get its share of the cores
        self._host_pool = ThreadPoolExecutor(
            max_workers=host_n, thread_name_prefix="fleet-host",
            initializer=native.limit_threads,
            initargs=(max(1, cpus // host_n),))
        self._ckpt_pool = ThreadPoolExecutor(max_workers=ckpt_n,
                                             thread_name_prefix="fleet-ckpt")
        #: (state, value, exc) triples whose generator can step now
        self._ready: collections.deque = collections.deque()
        #: sessions holding a slot, in admission order
        self._live: dict = {}
        self._score_wait: list = []   # (state, ScoreStep | DeviceStep)
        #: uid -> checkpoint generation of sessions released since the
        #: driver last called :meth:`take_released`
        self._released: dict = {}
        self._host_wait: dict = {}    # Future -> (state, HostStep)
        #: Future -> submit time (the hold's host-step telemetry)
        self._host_t0: dict = {}
        #: watchdog-abandoned host futures: their zombie threads run on
        #: against discarded session objects; teardown must not wait on
        #: one that hangs for good
        self._abandoned: list = []
        self._opened = True

    def admit(self, entry: FleetUser, *, pad: int | None = None
              ) -> _SessionState:
        """Add one user to the open engine at pool width ``pad``, pinned
        for the whole run."""
        self._apply_depth(entry.committee)
        st = self._make_session(entry, entry.committee, pad=pad)
        self._ready.append((st, None, None))
        return st

    def set_depth(self, depth: str) -> None:
        """``"cheap"`` caps every live and later committee at its
        ``min_members`` floor (``Committee.depth_cap``; a session picks it
        up at its next scoring pass); ``"full"`` restores it.  A capped
        committee is a different committee: its results differ."""
        if depth not in ("full", "cheap"):
            raise ValueError(f"unknown depth {depth!r} (full | cheap)")
        self.depth = depth
        for st in list(getattr(self, "_live", ())):
            self._apply_depth(st.entry.committee)

    def _apply_depth(self, committee) -> None:
        committee.depth_cap = (max(1, int(committee.min_members))
                               if self.depth == "cheap" else None)

    def pump(self) -> bool:
        """One scheduling round: step every ready session, then dispatch
        the waiting device batch or, with only host work left, wait for a
        host step.  Returns False when the engine is idle."""
        if not (self._ready or self._score_wait or self._host_wait):
            return False
        self._reap_hung_hosts()
        while self._ready:
            state, value, exc = self._ready.popleft()
            if exc is None and (state.force_release
                                or (state.release
                                    and state.last_label == "checkpoint")):
                # the fence point: the checkpoint this session just
                # committed is the migration's resume unit.  A force mark
                # releases at any step: the close discards the current
                # iteration and the workspace stays at its last commit
                self._release(state)
                continue
            state.last_label = None
            self._live[state] = None
            self._track(state, self._advance(state, value, exc))
        if self._score_wait:
            # the dispatch hold: wait up to this long for host steps in
            # flight, whose sessions may be one step from joining
            window = self.batch_window_s
            if self.hold is not None:
                window = max(window, self.hold.window_s(
                    len(self._score_wait), len(self._host_wait)))
            if self._host_wait and self._drain_host(window):
                # sessions finishing host work may be one step from their
                # own device step: let them join this batch
                return True
            batch, self._score_wait = self._score_wait, []
            if self.plan_chunk and self._host_wait:
                batch = self._hold_partial_plans(batch)
                if not batch:
                    self._wait_host()
                    return True
            for state, res in self._dispatch_scores(batch):
                self._ready.append((state, res, None))
            return True
        if self._host_wait:
            self._wait_host()
        return True

    def _wait_host(self) -> None:
        """Block until a host step finishes: this thread has nothing to
        launch.  Traced, the wait is a ``host_wait`` span."""
        if not self.tracer.enabled:
            self._drain_host(self._host_timeout())
            return
        with self.tracer.span("host_wait", parent=self.tracer.run_ctx):
            self._drain_host(self._host_timeout())

    def _host_timeout(self):
        """How long a blocking host wait may last: until the next armed
        watchdog deadline could expire, or without bound."""
        return None if self.watchdog is None else self.watchdog.poll_s()

    @property
    def has_work(self) -> bool:
        return bool(self._ready or self._score_wait or self._host_wait)

    @property
    def n_live(self) -> int:
        """Sessions holding a slot, plus admissions not yet stepped."""
        return len(self._live) + sum(1 for s, _, _ in self._ready
                                     if s not in self._live)

    @property
    def results(self) -> dict:
        """``id(entry)`` -> the record of each finished or failed user."""
        return self._results

    def abort(self) -> None:
        """The error path (``Preempted``, ``InjectedKill``, interrupt):
        join the host workers (they touch session state), then close every
        live generator, so each session's checkpointer joins its commit."""
        self._shutdown_host_pool()
        for state in list(self._live):
            try:
                state.gen.close()
            except Exception:
                pass

    def close(self) -> None:
        """Join both pools and retire the engine.  Every generator was
        closed before (finished ones inside themselves, the rest in
        :meth:`abort`), so the checkpoint pool holds no pending commit."""
        self._shutdown_host_pool()
        self._ckpt_pool.shutdown(wait=True)
        if self._profile is not None:  # fewer than profile_n dispatches
            self.profile_path = self._profile.stop()
            self._profile = None
        self._opened = False

    def _shutdown_host_pool(self) -> None:
        """Join the host pool: without a watchdog, until every host step
        finished.  With one, teardown is bounded by its deadline: tracked
        steps get one deadline to finish (the abort path, where a hung
        step was never reaped), and a step still alive after that, or an
        abandoned zombie still running, is left to the interpreter rather
        than wedging shutdown on the hang the watchdog exists to bound."""
        if self.watchdog is None:
            self._host_pool.shutdown(wait=True)
            return
        if self._host_wait:
            wait(list(self._host_wait), timeout=self.watchdog.deadline_s)
        hung = any(not f.done() for f in self._abandoned) \
            or any(not f.done() for f in self._host_wait)
        self._host_pool.shutdown(wait=not hung)

    # -- session plumbing --------------------------------------------------

    def _make_session(self, entry: FleetUser, committee, *,
                      pad: int | None = None,
                      pin_pad: int | None = None) -> _SessionState:
        timer = StepTimer(os.path.join(entry.user_path, "timings.jsonl"))
        session = UserSession(
            self.config, committee, entry.data, entry.user_path,
            seed=entry.seed, tie_break=self.tie_break,
            retrain_epochs=self.retrain_epochs, pad_pool_to=pad,
            timer=timer, preemption=self.preemption,
            ckpt_executor=self._ckpt_pool, pin_pad=pin_pad,
            cnn_steps=self.stack_cnn, fuse_step=self.fuse_step,
            device=self.device, mesh=self.mesh, tracer=self.tracer)
        return _SessionState(entry, session, session.steps(), pad=pad,
                             n_pad=session.acq.n_pad)

    def _advance(self, state: _SessionState, value=None, exc=None):
        """Step a generator: the next step, or ``None`` when the session
        finished or was evicted (both recorded)."""
        try:
            if exc is not None:
                return state.gen.throw(exc)
            if not state.started:
                state.started = True
                return next(state.gen)
            return state.gen.send(value)
        except StopIteration as stop:
            self._finish(state, stop.value)
        except Exception as e:  # Preempted / InjectedKill pass through
            self._evict(state, e)
        return None

    def _track(self, state: _SessionState, step) -> None:
        if step is None:
            self._live.pop(state, None)
        elif isinstance(step, (ScoreStep, DeviceStep)):
            self._score_wait.append((state, step))
        else:
            fn = step.fn
            if self.tracer.enabled:
                # the pooled block's span under the session's current
                # iteration, read here while the generator is suspended;
                # keyed (user, epoch, label), so a re-run after an
                # eviction writes the same id
                uid = str(state.entry.user_id)
                name = ("checkpoint" if step.label == "checkpoint"
                        else "host_step")
                ctx = state.session.trace_ctx
                key = (uid, state.session.trace_epoch, step.label)

                def fn(fn=step.fn, name=name, ctx=ctx, key=key, uid=uid,
                       label=step.label or "host"):
                    with self.tracer.span(name, parent=ctx, key=key,
                                          user=uid, label=label):
                        return fn()
            fut = self._host_pool.submit(self._timed_host_step, fn,
                                         step.label or "host")
            self._host_wait[fut] = (state, step)
            # submit -> completion: the hold's host-step telemetry
            self._host_t0[fut] = time.monotonic()  # cetpu: noqa[replay-wallclock] hold-sizing telemetry; holds change when work batches, never results
            if self.watchdog is not None:
                self.watchdog.arm(state, step.label or "host")

    def _timed_host_step(self, fn, label: str):
        """Run a host step on a worker, recording its interval in the
        report (unix-epoch ns, the clock of ``torch.profiler``'s events)."""
        t0 = time.time_ns()  # cetpu: noqa[replay-wallclock] host-step interval for torch.profiler alignment (telemetry; replay never reads it)
        try:
            return fn()
        finally:
            self.report.host_step(label, t0, time.time_ns())  # cetpu: noqa[replay-wallclock] host-step interval for torch.profiler alignment (telemetry; replay never reads it)

    def _drain_host(self, timeout) -> int:
        """Move finished host steps back to the ready queue; how many
        finished within ``timeout``."""
        if not self._host_wait:
            return 0
        done, _ = wait(list(self._host_wait), timeout=timeout,
                       return_when=FIRST_COMPLETED)
        note = getattr(self.hold, "note_host_step", None)
        for fut in done:
            state, step = self._host_wait.pop(fut)
            # the release check in pump reads this: a completed
            # "checkpoint" step is a fence-marked session's release point
            state.last_label = getattr(step, "label", None)
            t0 = self._host_t0.pop(fut, None)
            if note is not None and t0 is not None:
                note(time.monotonic() - t0)  # cetpu: noqa[replay-wallclock] hold-sizing telemetry; holds change when work batches, never results
            if self.watchdog is not None:
                self.watchdog.disarm(state)
            err = fut.exception()
            # a failure is thrown into the generator: the session's own
            # error path runs, as if the block had raised inline
            self._ready.append((state, fut.result(), None) if err is None
                               else (state, None, err))
        return len(done)

    def _reap_hung_hosts(self) -> None:
        """Evict the sessions whose host step blew the watchdog deadline:
        the future is abandoned (a thread cannot be killed; the zombie
        finishes against the discarded session's objects) and the timeout
        is thrown into the generator, whose error path runs and whose user
        :meth:`_evict` resumes from its workspace."""
        if self.watchdog is None or not self._host_wait:
            return
        expired = {key: (label, elapsed)
                   for key, label, elapsed in self.watchdog.expired()}
        if not expired:
            return
        for fut, (state, step) in list(self._host_wait.items()):
            if state not in expired or fut.done():
                continue  # a done future drains normally
            del self._host_wait[fut]
            self._host_t0.pop(fut, None)
            self._abandoned.append(fut)
            label, elapsed = expired[state]
            exc = self.watchdog.trip(state, label, elapsed)
            self.report.event("watchdog_evict",
                              user=str(state.entry.user_id),
                              step=step.label or "host",
                              elapsed_s=round(elapsed, 3),
                              deadline_s=self.watchdog.deadline_s)
            self._ready.append((state, None, exc))

    def _finish(self, state: _SessionState, result: dict) -> None:
        phases = {}
        for rec in state.session.timer.records:
            for k, v in rec.items():
                if k.endswith("_s"):
                    phases[k] = phases.get(k, 0.0) + v
        self.report.user_done(state.entry.user_id, result, phases)
        self.tracer.close_user(str(state.entry.user_id),
                               resumes=state.resumes)
        self._results[id(state.entry)] = {
            "user": state.entry.user_id, "result": result,
            "committee": state.session.committee,
            "resumes": state.resumes, "error": None}

    def request_release(self, user_id) -> bool:
        """Mark a live session for release at its next completed
        checkpoint boundary (the fence): its generator is closed there,
        joining the staged commit, and the user leaves the engine with no
        result and no failure; the driver places it elsewhere, where
        resume replays the fenced workspace.  False when no live session
        matches (finished or evicted first: the fence is refused)."""
        uid = str(user_id)
        for st in list(self._live) + [s for s, _, _ in self._ready]:
            if str(st.entry.user_id) == uid:
                st.release = True
                return True
        return False

    def force_release(self, user_id) -> bool:
        """The fence deadline's fallback: release the session at its
        next ready pop, any step boundary.  The current iteration's
        in-memory progress is dropped (the generator's close path); the
        workspace stays at its last committed generation, which resume
        elsewhere replays.  False when no live session matches."""
        uid = str(user_id)
        for st in list(self._live) + [s for s, _, _ in self._ready]:
            if str(st.entry.user_id) == uid:
                st.force_release = True
                return True
        return False

    def take_released(self) -> dict:
        """``{user_id: checkpoint generation}`` of the sessions released
        since the last call (``None`` when one never committed a
        generation: the target starts the user from its unstarted
        workspace)."""
        out, self._released = self._released, {}
        return out

    def _release(self, state: _SessionState) -> None:
        """Close a marked session at its boundary: the generator's close
        joins its checkpointer (the commit is durable before the release
        is reported), its iteration's span ends, the slot frees, and the
        user surfaces through :meth:`take_released` with its generation.
        A session whose checkpoints run inline never reaches this point
        for a fence and finishes where it is."""
        self._live.pop(state, None)
        try:
            state.gen.close()
        except Exception:
            pass
        # the closed generator never reaches its iteration span's end
        state.session.end_iteration_span(
            released="evict" if state.force_release else "fence")
        uid = str(state.entry.user_id)
        self._released[uid] = state.session.ckpt_epoch
        self.report.event("fence_release", user=uid,
                          gen=state.session.ckpt_epoch)

    def _evict(self, state: _SessionState, exc: Exception) -> None:
        """Tear one faulted session down and, when possible, resume the
        user from its workspace at its admitted width; its error path
        already joined its checkpointer, so the workspace is quiescent."""
        entry = state.entry
        self.report.event("evict", user=str(entry.user_id),
                          error=repr(exc), resumes=state.resumes)
        if (entry.committee_factory is None
                or state.resumes >= self.MAX_RESUMES):
            self._terminal(entry, repr(exc), state.resumes)
            return
        try:
            committee = entry.committee_factory()
        except Exception as load_err:
            self._terminal(entry, f"{exc!r}; resume reload failed: "
                                  f"{load_err!r}", state.resumes)
            return
        self._apply_depth(committee)
        new = self._make_session(entry, committee, pad=state.pad,
                                 pin_pad=state.n_pad)
        new.resumes = state.resumes + 1
        self.report.event("resume", user=str(entry.user_id),
                          attempt=new.resumes)
        self._ready.append((new, None, None))

    def _terminal(self, entry: FleetUser, error: str, resumes: int) -> None:
        """Out of in-engine recovery.  ``on_terminal`` decides first: True
        means the driver took the user back (the serve layer re-queues it
        with backoff; no record, the user's span stays open)."""
        if self.on_terminal is not None \
                and self.on_terminal(entry, error, resumes):
            return
        self.report.user_failed(entry.user_id, error, attempts=resumes + 1)
        self.tracer.close_user(str(entry.user_id), error=error)
        self._results[id(entry)] = {
            "user": entry.user_id, "result": None, "committee": None,
            "resumes": resumes, "error": error}

    # -- stacked dispatch --------------------------------------------------

    @staticmethod
    def _sig(x):
        if ops_scoring.is_key_array(x):
            return ("key", tuple(x.shape))
        if isinstance(x, ShardedRows):
            return ("sharded", x.shape, str(x.dtype), x.offsets,
                    tuple(map(str, x.devices)))
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), str(x.dtype), str(x.device))
        arr = np.asarray(x)  # cetpu: noqa[implicit-host-sync] host operand: every tensor returned above, so nothing leaves the card
        return (arr.shape, str(arr.dtype))

    @staticmethod
    def _stack(vals):
        if ops_scoring.is_key_array(vals[0]):
            return ops_scoring.stack_user_keys(vals)
        if isinstance(vals[0], ShardedRows):
            return ShardedRows.stack(vals)
        return torch.stack([torch.as_tensor(v) for v in vals])

    def _h2d(self, vals) -> tuple:
        """``(bytes, uploads)`` of the operands not on the dispatch device
        (numpy, or tensors elsewhere): each is a host->device copy.  A
        sharded operand lives on its mesh."""
        host = [v for v in vals if not (
            isinstance(v, ShardedRows) or (isinstance(v, torch.Tensor)
                                           and v.device == self.device))]
        return (sum(int(np.asarray(v).nbytes) if not isinstance(  # cetpu: noqa[implicit-host-sync] host operands only (tensors take the other branch): counts their bytes
            v, torch.Tensor) else v.numel() * v.element_size()
            for v in host), len(host))

    def _group_fns(self, width: int) -> dict:
        """The stacked scorers of one dispatch group: the shared fleet
        family, the width-guarded one when admitting by bucket, or on a
        mesh the pool-sharded per-width family."""
        if self.mesh is not None:
            from consensus_entropy_tpu_torch.parallel import pool_mesh

            return pool_mesh.sharded_fleet_fns_for_width(
                self.mesh, k=self.config.queries,
                tie_break=self.tie_break, width=width)
        if not self.scoring_by_width:
            return self._fleet_fns
        return ops_scoring.fleet_scoring_fns_for_width(
            k=self.config.queries, tie_break=self.tie_break, width=width)

    def _active_in_bucket(self, width: int) -> int:
        """Live sessions padded to ``width``: the denominator of a bucket's
        occupancy (finished and evicted sessions left ``_live``)."""
        return sum(1 for s in self._live if s.n_pad == width)

    def _hold_partial_plans(self, steps: list) -> list:
        """Split a round into what dispatches now and what waits: plan
        groups release whole ``plan_chunk`` quanta and hold their
        remainder for the same-key plans the in-flight host steps are
        about to produce; score steps always pass.  Called only while host
        steps are in flight, so nothing held can starve."""
        groups = collections.defaultdict(list)
        for st, step in steps:
            key = (("__plan__",) + step.plan.group_key()
                   if isinstance(step, DeviceStep) else None)
            groups[key].append((st, step))
        out = []
        for key, group in groups.items():
            keep = (len(group) if key is None else
                    (len(group) // self.plan_chunk) * self.plan_chunk)
            out.extend(group[:keep])
            self._score_wait.extend(group[keep:])
        return out

    def _dispatch_scores(self, steps: list) -> list:
        """Serve a round of score and device steps: group by (scorer,
        shapes), plans by ``group_key()``; a group of two or more is one
        stacked dispatch, a group of one the session's own call.  Returns
        ``[(state, result), ...]``.

        A failed stacked dispatch is recorded (``dispatch_failed``, and on
        the breaker, which may open the width) and its group served one
        session at a time; a width whose breaker is open is served that
        way from the start.  A session whose own call fails is evicted
        through its generator's error path, its peers untouched.  Stacked
        scoring calls are all launched before any row is handed out, so
        the next group's stacking overlaps the previous one's device
        work."""
        groups = collections.defaultdict(list)
        for st, step in steps:
            if isinstance(step, DeviceStep):
                key = ("__plan__",) + step.plan.group_key()
            else:
                key = (step.fn_key,) + tuple(self._sig(x)
                                             for x in step.inputs)
            groups[key].append((st, step))
        n_live = len(self._live)
        rounds = []
        for key, group in groups.items():
            if (self.plan_chunk and key[0] == "__plan__"
                    and len(group) > self.plan_chunk):
                rounds.extend(group[i:i + self.plan_chunk]
                              for i in range(0, len(group),
                                             self.plan_chunk))
            else:
                rounds.append(group)

        def grade(fn_key, batch, width, wall, h2d=(None, None), w0=None,
                  span=None):
            if span is not None:
                self.tracer.end(span)
            self.step_wall_ema = (
                wall if self.step_wall_ema is None
                else 0.8 * self.step_wall_ema + 0.2 * wall)
            self.report.dispatch(
                fn_key, batch,
                self._active_in_bucket(width) if self.scoring_by_width
                else n_live, wall,
                width=width if self.scoring_by_width else None,
                h2d_bytes=h2d[0], h2d_ops=h2d[1])
            if w0 is not None and self.tracer.enabled:
                # one span serves N users: it parents the run context, on
                # its bucket's lane
                self.tracer.span_at(
                    "retrain" if fn_key == "cnn_retrain"
                    else "score_dispatch",
                    w0, w0 + wall, parent=self.tracer.run_ctx, fn=fn_key,
                    width=width if self.scoring_by_width else None,
                    batch=batch)

        def closed(width):
            if self.breaker is not None \
                    and self.breaker.record_success(width) == "close":
                self.report.event("breaker_close", width=width)

        out, single, pending = [], [], []
        for group in rounds:
            width = group[0][0].n_pad
            step0 = group[0][1]
            fn_key = (step0.plan.fn_key if isinstance(step0, DeviceStep)
                      else step0.fn_key)
            stacked = len(group) > 1
            if stacked and self.breaker is not None:
                stacked = self.breaker.allow_stacked(width)
                if stacked and self.breaker.state_of(width) == "half_open":
                    self.report.event("breaker_probe", width=width)
            if not stacked:
                single.append((group, width, fn_key))
                continue
            span = self._retrain_span(fn_key, width, len(group))
            w0 = time.time()  # cetpu: noqa[replay-wallclock] span wall-stamp (telemetry; span ids stay deterministic)
            t0 = time.perf_counter()
            try:
                if isinstance(step0, DeviceStep):
                    served = self._plan_call(fn_key, width, group, span)
                else:
                    batched, h2d = self._stacked_call(fn_key, width, group)
            except Exception as exc:
                if span is not None:
                    self.tracer.end(span, failed=True)
                self._note_stacked_failure(fn_key, width, exc)
                single.append((group, width, fn_key))
                continue
            if isinstance(step0, DeviceStep):
                out.extend(served)
                closed(width)
                grade(fn_key, len(group), width, time.perf_counter() - t0,
                      w0=w0 if span is None else None, span=span)
            else:
                # the wall is taken at launch: the later groups' stacking
                # is not this dispatch's
                pending.append((group, width, fn_key,
                                time.perf_counter() - t0, batched, h2d, w0))
        for group, width, fn_key, wall, batched, h2d, w0 in pending:
            closed(width)
            grade(fn_key, len(group), width, wall, h2d, w0=w0)
            out.extend(self._result_rows(fn_key, batched, group))
        for group, width, fn_key in single:
            for st, step in group:
                w0 = time.time()  # cetpu: noqa[replay-wallclock] span wall-stamp (telemetry; span ids stay deterministic)
                t0 = time.perf_counter()
                try:
                    res = self._single_call(step)
                except Exception as exc:
                    self.report.event("dispatch_session_error",
                                      user=str(st.entry.user_id),
                                      fn=fn_key, error=repr(exc))
                    self._ready.append((st, None, exc))
                    continue
                out.append((st, res))
                wall = time.perf_counter() - t0
                if isinstance(step, DeviceStep):
                    grade(fn_key, 1, width, wall, w0=w0)
                else:
                    b1, o1 = self._h2d(step.inputs)
                    b2, o2 = step.session.acq.take_h2d()
                    grade(fn_key, 1, width, wall, (b1 + b2, o1 + o2),
                          w0=w0)
        return out

    def _retrain_span(self, fn_key: str, width: int, batch: int):
        """The open ``retrain`` span of a stacked retrain (``None`` for
        another dispatch, or untraced), begun before the call so that its
        fits are its children.  A call that raises ends it ``failed``, so
        they keep their parent; the per-user fallback then writes a
        ``retrain`` span a user, as a dispatch of one does."""
        if fn_key != "cnn_retrain" or not self.tracer.enabled:
            return None
        return self.tracer.begin(
            "retrain", parent=self.tracer.run_ctx, fn=fn_key,
            width=width if self.scoring_by_width else None, batch=batch)

    def _guarded(self, dispatch, what: str):
        """Run one device dispatch: under the watchdog's deadline when one
        is installed (on its thread: the card's default stream orders the
        work as inline calls are), inside the profiler's window."""
        self._profile_start()
        res = (self.watchdog.call(dispatch, what)
               if self.watchdog is not None else dispatch())
        self._profile_tick()
        return res

    def _stacked_call(self, fn_key: str, width: int, group: list):
        """Stack a group's inputs and launch one fleet-scorer call; returns
        ``(batched_result, (h2d_bytes, h2d_ops))``.  The per-user probs
        buffers and masks already live on the device, so stacking them is
        a device copy; only operands still on the host count as uploads."""
        h2d, drained = (0, 0), []
        for _, step in group:
            b1, o1 = self._h2d(step.inputs)
            b2, o2 = step.session.acq.take_h2d()
            drained.append((step.session.acq, b2, o2))
            h2d = (h2d[0] + b1 + b2, h2d[1] + o1 + o2)

        def dispatch():
            faults.fire("serve.dispatch", fn=fn_key, width=width,
                        batch=len(group))
            stacked = [self._stack([step.inputs[pos] for _, step in group])
                       for pos in range(len(group[0][1].inputs))]
            d0 = time.perf_counter()
            res = self._group_fns(width)[fn_key](*stacked)
            # a pending ``slow`` rule stretches the call on this thread,
            # inside the watchdog's deadline
            faults.slow_hold("serve.dispatch", time.perf_counter() - d0)
            return res

        try:
            batched = self._guarded(dispatch, f"dispatch {fn_key}@{width}")
        except BaseException:
            # the per-user fallback grades these uploads
            for acq, b2, o2 in drained:
                acq.device.h2d_bytes += b2
                acq.device.h2d_ops += o2
            raise
        return batched, h2d

    @staticmethod
    def _result_rows(fn_key: str, batched, group: list) -> list:
        """Each session's row of a stacked result, of the same result type.
        A fused step's masks are copied into the session's OWN mask
        tensors (the inputs it staged), which become its result's masks:
        each device twin then holds what its single fused call leaves, and
        no user keeps a view into the cohort's stacked buffer."""
        cls = type(batched)
        masks = ops_scoring.FUSED_MASKS.get(fn_key)
        rows = []
        for i, (st, step) in enumerate(group):
            fields = [None if x is None else x[i] for x in batched]
            if masks is not None:
                pool_pos, hc_pos = masks
                fields[3] = step.inputs[pool_pos].copy_(fields[3])
                if hc_pos is not None:
                    fields[4] = step.inputs[hc_pos].copy_(fields[4])
            rows.append((st, cls(*fields)))
        return rows

    def _plan_call(self, fn_key: str, width: int, group: list,
                   span=None) -> list:
        """One stacked CNN dispatch for a plan group: the pure compute
        (under the watchdog), then the commit (a retrain's member
        rebinding) on this thread, so an abandoned dispatch that finishes
        late never rebinds committees that took the per-user path.
        ``span``: the dispatch's open span, its fits' parent."""
        plans = [step.plan for _, step in group]

        def dispatch():
            faults.fire("serve.dispatch", fn=fn_key, width=width,
                        batch=len(group))
            d0 = time.perf_counter()
            res = committee_mod.stage_device_plans(
                plans, tracer=self.tracer, parent=span)
            faults.slow_hold("serve.dispatch", time.perf_counter() - d0)
            return res

        computed = self._guarded(dispatch, f"dispatch {fn_key}@{width}")
        results = committee_mod.commit_device_plans(plans, computed)
        return [(st, res) for (st, _), res in zip(group, results)]

    def _single_call(self, step):
        """One session's own dispatch, the sequential path, under the
        watchdog like a stacked one."""
        fn_key = (step.plan.fn_key if isinstance(step, DeviceStep)
                  else step.fn_key)

        def dispatch():
            faults.fire("serve.dispatch", fn=fn_key,
                        width=step.session.acq.n_pad, batch=1)
            d0 = time.perf_counter()
            if isinstance(step, DeviceStep):
                res = step.single()
            else:
                res = step.session.acq.run_scoring(step.fn_key, step.inputs)
            faults.slow_hold("serve.dispatch", time.perf_counter() - d0)
            return res

        return self._guarded(dispatch, f"dispatch {fn_key}x1")

    def _profile_start(self) -> None:
        """Open the device profiler at the first dispatch."""
        if self._profile_left and self._profile is None:
            self._profile = DeviceProfile(self._profile_dir, self.device)
            self._profile.start()

    def _profile_tick(self) -> None:
        """One dispatch done inside the profiler's window; close it (and
        export its trace) after ``profile_n``."""
        if self._profile is None:
            return
        self._profile_left -= 1
        if self._profile_left <= 0:
            self.profile_path = self._profile.stop()
            self._profile = None

    def _note_stacked_failure(self, fn_key: str, width: int,
                              exc: Exception) -> None:
        self.report.event("dispatch_failed", fn=fn_key, width=width,
                          error=repr(exc))
        if self.breaker is None:
            return
        verdict = self.breaker.record_failure(width)
        if verdict == "open":
            self.report.event("breaker_open", width=width,
                              threshold=self.breaker.threshold,
                              cooldown_s=self.breaker.cooldown_s)
        elif verdict == "giveup":
            # the probe budget is spent: per-user for the rest of the run
            self.report.event("breaker_giveup", width=width,
                              probes=self.breaker.probe_budget)

    # -- the cohort runner -------------------------------------------------

    def run(self, users: list[FleetUser]) -> list[dict]:
        """Run the cohort to completion; one record per user, in input
        order: ``{"user", "result", "committee", "resumes", "error"}``
        (``error`` set for a user that failed terminally)."""
        if not users:
            return []
        pad = self.pad_pool_to
        if pad is None:
            # one width across the cohort: every user's scoring inputs then
            # share a shape and stack into one dispatch
            pad = max(u.data.pool.n_songs for u in users)
        self.open(len(users))
        try:
            for u in users:
                self.admit(u, pad=pad)
            while self.pump():
                pass
        except BaseException:
            self.abort()
            raise
        finally:
            self.close()
        return [self._results[id(u)] for u in users]
