"""The per-user AL loop as a steppable coroutine.

Counterpart of ``consensus_entropy_tpu/fleet/session.py``: ``UserSession.
steps`` is a generator that yields at the points where a multi-user
scheduler can interleave work (the JAX session's ``:549, 572, 593, 688,
707, 749, 756, 806, 835, 850, 872, 909, 925``):

- :class:`ScoreStep`: the staged scoring call (``Acquirer.
  scoring_inputs``); the fleet stacks a cohort's same-shaped steps into
  one call of the fleet scorers;
- :class:`HostStep`: a block of host work (member predicts, updates and
  evaluation, the checkpoint boundary); the fleet runs it on a bounded
  worker pool, overlapping other users' device work;
- :class:`DeviceStep`: a batchable CNN device call (the probs producer,
  the evaluation forward, the retrain) staged as a ``models.committee``
  plan; the fleet serves a group of same-signature plans with one stacked
  dispatch, and a group of one with the step's ``single`` closure.

The sequential runner, :func:`drive_inline`, answers each step at once
(``ALLoop.run_user`` is this), so a fleet run executes the same statements
in the same per-user order with the same key stream as the sequential one
(one ``prng.split`` for each ``jax.random.split``).  A host step never
touches a tensor: the values it needs from the device are pulled to numpy
on the generator's thread before the step is yielded, and host steps are
offered only to committees whose host members score on the host.  With a
pool-axis ``mesh`` the acquirer selects sharded and the CNN work stays
inline.  Across processes (``parallel.multihost``) only the coordinator
writes the workspace and the report, the preemption flag is agreed by
every process at each boundary, and a barrier closes the run.

With a ``tracer`` (``obs.trace.Tracer``) the session opens the user's root
span and one ``al_iter`` span an iteration (``begin``/``end``, keyed by
user and epoch): an iteration cut short by a kill or an eviction leaves
its span unwritten, and the resumed attempt, which re-runs it, writes the
same id, so the children written before the fault keep their parent.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.al import state as al_state
from consensus_entropy_tpu_torch.al.acquisition import Acquirer
from consensus_entropy_tpu_torch.al.reporting import UserReport
from consensus_entropy_tpu_torch.config import ALConfig
from consensus_entropy_tpu_torch.labels import one_hot_np
from consensus_entropy_tpu_torch.obs.metrics import StepTimer
from consensus_entropy_tpu_torch.obs.trace import NULL_TRACER
from consensus_entropy_tpu_torch.parallel import multihost
from consensus_entropy_tpu_torch.resilience import faults
from consensus_entropy_tpu_torch.resilience.preemption import Preempted
from consensus_entropy_tpu_torch.resilience.retry import retry_transient


@dataclasses.dataclass
class ScoreStep:
    """Request: run ``session.acq``'s staged scoring call and answer with
    its result (the single call, or the user's row of a stacked one)."""

    session: "UserSession"
    fn_key: str
    inputs: tuple


@dataclasses.dataclass
class HostStep:
    """Request: call ``fn()`` (host work, numpy in and out) and answer with
    its return value.  ``label`` names the phase for the scheduler."""

    session: "UserSession"
    fn: Callable
    label: str = ""


@dataclasses.dataclass
class DeviceStep:
    """Request: run a batchable CNN device call.  ``plan`` is a
    ``models.committee`` plan (its ``group_key()`` groups a cohort);
    ``single`` is this session's own per-user path, with its retry and
    fault wrapping, used by the sequential runner, by a group of one and
    when a stacked dispatch fails.  The answer is the plan's result."""

    session: "UserSession"
    plan: object
    single: Callable
    label: str = ""


def drive_inline(session: "UserSession") -> dict:
    """Service a session synchronously: the sequential ``run_user``.  Score
    steps go through the session's own scorers, device steps through their
    ``single`` closure, host steps run inline.  A servicer failure is
    thrown into the generator, so the session's own error path
    (checkpointer joined, report closed) runs before the error
    propagates."""
    gen = session.steps()
    try:
        step = next(gen)
        while True:
            try:
                if isinstance(step, ScoreStep):
                    value = step.session.acq.run_scoring(step.fn_key,
                                                         step.inputs)
                elif isinstance(step, DeviceStep):
                    value = step.single()
                else:
                    value = step.fn()
            except BaseException as e:
                step = gen.throw(e)
            else:
                step = gen.send(value)
    except StopIteration as stop:
        return stop.value
    finally:
        gen.close()


def _split(key):
    """``key, sub = jax.random.split(key)``."""
    keys = prng.split(key)
    return keys[0], keys[1]


def _host(x):
    """A tensor's values as numpy, pulled on the calling thread (numpy and
    ``None`` pass through)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


class UserSession:
    """One user's AL run, initialized as ``run_user`` would: resume state,
    split, acquirer and checkpointer; :meth:`steps` is the iteration
    generator.  ``device`` is where the acquisition runs (``None`` is the
    card); the per-user key stream stays on the host.

    ``ckpt_executor``: a shared pool behind this session's checkpointer
    (the fleet's).  ``pin_pad``: the padded pool width this user was
    admitted at; a rebuilt session (eviction, preemption) that pads to
    another width raises.  ``cnn_steps``: yield the CNN device work as
    :class:`DeviceStep` plans (``False`` keeps it inline).  ``mesh``: the
    acquirer's pool-axis mesh; a meshed session keeps every step inline
    (its operands are placed on the mesh, not stackable across users).
    ``tracer``: the span tracer (the null one by default)."""

    def __init__(self, config: ALConfig, committee, data, user_path: str, *,
                 seed: int | None = None, tie_break: str = "fast",
                 retrain_epochs: int | None = None,
                 pad_pool_to: int | None = None, resume: bool = True,
                 timer: StepTimer | None = None, preemption=None,
                 ckpt_executor=None, pin_pad: int | None = None,
                 cnn_steps: bool = True, fuse_step: bool = True,
                 device=None, mesh=None, tracer=None):
        from consensus_entropy_tpu_torch.al.loop import (
            AsyncCheckpointer,
            grouped_split,
        )

        cfg = config
        self.config = cfg
        self.committee = committee
        self.data = data
        self.user_path = user_path
        self.seed = cfg.seed if seed is None else seed
        self.timer = timer or StepTimer(None)
        self.preemption = preemption
        #: CNN retrain epochs an iteration (None: ``n_epochs_retrain``)
        self.retrain_epochs = retrain_epochs
        self.mesh = mesh
        self.result: dict | None = None
        self.tracer = NULL_TRACER if tracer is None else tracer
        #: the current iteration's span and epoch: the scheduler parents a
        #: pooled host step's span under them
        self.trace_ctx = None
        self.trace_epoch = None
        self.tracer.open_user(str(data.user_id))
        # the config's survivor floor never weakens a stricter committee
        committee.min_members = max(committee.min_members, cfg.min_members)
        #: wmc: per-member reliability weights by member name, persisted
        #: in ALState so a resumed run replays them
        self.member_weights: dict = {}
        #: the member-name order of the last scoring pass's probs axis
        self._scoring_member_names: list | None = None

        st = al_state.ALState.load(user_path) if resume else None
        # every process has read the resume state before the coordinator's
        # first commit of this run can replace it: a process that read it
        # later would resume where the others start fresh, and the two
        # would wait in different collectives (a barrier of the port's
        # own: it does not fire ``multihost.sync``, which JAX fires once a
        # user, at the run's end)
        multihost.barrier()
        if st is not None and not st.matches(
                mode=cfg.mode, seed=self.seed, queries=cfg.queries,
                train_size=cfg.train_size):
            raise ValueError(
                f"{user_path} holds resume state for a different experiment "
                f"(mode={st.mode} seed={st.seed} q={st.queries} "
                f"train_size={st.train_size}); delete the directory or pass "
                "the experiment to workspace.create_user")
        self._fresh = st is None
        if st is not None:
            self.split = self._rebuild_split(data, st)
            self.key = st.unpack_key()
            if st.member_weights:
                self.member_weights = dict(st.member_weights)
            self.trajectory = list(st.trajectory)
            self.queried_hist = [al_state.remap_songs(b, data.pool.song_ids)
                                 for b in st.queried]
            self.start_epoch = st.next_epoch
        else:
            rng = np.random.default_rng(self.seed)
            self.key = prng.key(self.seed, "cpu")
            self.split = grouped_split(data.pool, data.labels,
                                       cfg.train_size, rng)
            self.trajectory = []
            self.queried_hist = []
            self.start_epoch = 0
        #: the checkpoint generation this session last staged (a fence
        #: release reports it after the generator's close joined the
        #: commit); a fresh session has none until its baseline commits
        self.ckpt_epoch: int | None = (self.start_epoch if st is not None
                                       else None)

        hc_rows = None
        if data.hc_rows is not None:
            rows = data.pool.row_of(self.split.train_songs)
            hc_rows = np.asarray(data.hc_rows)[rows]
        self.acq = Acquirer(self.split.train_songs, hc_rows,
                            queries=cfg.queries, mode=cfg.mode,
                            tie_break=tie_break, seed=self.seed,
                            pad_to=pad_pool_to, fuse_step=fuse_step,
                            device=device, mesh=mesh)
        if pin_pad is not None and self.acq.n_pad != pin_pad:
            # a user's padded width is part of its run: a rebuild on another
            # width would move it to another dispatch group mid-run
            raise ValueError(
                f"pinned pool pad drifted on resume: this run admitted "
                f"user {data.user_id!r} at width {pin_pad}, rebuild "
                f"padded to {self.acq.n_pad}")
        self.acq.replay(self.queried_hist)
        self.ckpt = AsyncCheckpointer(executor=ckpt_executor)
        #: the last finished background job's self-timed durations
        self.bg_times: dict = {}
        #: whole iteration blocks may run on host workers only when none
        #: touches a tensor: no CNN member, no device slice, no mesh
        self.host_offloadable = (not committee.cnn_members
                                 and not committee.device_members
                                 and mesh is None)
        #: the CNN device work is yielded as batchable DeviceSteps (a
        #: meshed committee keeps its placements: inline)
        self.cnn_steps = (cnn_steps and bool(committee.cnn_members)
                          and mesh is None)
        #: per step: a CNN committee's host members (scored on the host)
        #: still ride the worker pool; their blocks take numpy only
        self.sklearn_offloadable = self.host_offloadable or (
            self.cnn_steps and bool(committee.host_members)
            and not committee.device_members)
        #: checkpoint boundaries (the previous commit's join, the staging
        #: writes) are host work for every committee without a device
        #: slice in its host block
        self.boundary_offloadable = self.host_offloadable or self.cnn_steps

    @staticmethod
    def _rebuild_split(data, st: al_state.ALState):
        from consensus_entropy_tpu_torch.al.loop import split_from_songs

        return split_from_songs(
            data.pool, data.labels,
            al_state.remap_songs(st.train_songs, data.pool.song_ids),
            al_state.remap_songs(st.test_songs, data.pool.song_ids))

    def _weights_vector(self) -> np.ndarray:
        """The ``(M,)`` reliability weights aligned with the next pass's
        probs axis (active members, committee order); unseen members start
        at 1.  Records the name order for the post-reveal update."""
        c = self.committee
        names = ([m.name for m in c.active_cnn_members]
                 + [m.name for m in c.active_host_members])
        self._scoring_member_names = names
        return np.array([self.member_weights.get(nm, 1.0)
                         for nm in names], np.float32)

    def _update_member_weights(self, member_probs, live_songs,
                               q_songs) -> None:
        """wmc: move each member's weight by an EMA toward its fraction of
        correctly predicted queried songs, read from the probs table the
        selection scored."""
        cfg = self.config
        if (cfg.consensus_weighting != "agreement" or not q_songs
                or member_probs is None
                or cfg.consensus_weight_alpha <= 0):
            return
        alpha = cfg.consensus_weight_alpha
        probs = (member_probs.cpu().numpy()
                 if hasattr(member_probs, "cpu") else
                 np.asarray(member_probs))
        row = {s: i for i, s in enumerate(live_songs)}
        idx = [row[s] for s in q_songs]
        pred = probs[:, idx, :].argmax(axis=-1)
        truth = np.asarray([self.data.labels[s] for s in q_songs])
        agree = (pred == truth).mean(axis=1)
        quarantined = self.committee.quarantined
        for nm, a in zip(self._scoring_member_names or [], agree):
            if nm in quarantined:
                continue  # its row was sanitized, not its own prediction
            w = self.member_weights.get(nm, 1.0)
            self.member_weights[nm] = (1.0 - alpha) * w + alpha * float(a)

    def _evaluate(self, report: UserReport, key,
                  cnn_probs=None) -> list[float]:
        """F1 of every active member on the test split, committee order
        (CNN members first, each on one random crop a test song under
        ``key``); a member whose predict raises or whose CNN probabilities
        go non-finite is quarantined and left out.  ``cnn_probs``: the CNN
        forward as numpy, produced already (:meth:`_eval_forward`)."""
        committee, split = self.committee, self.split
        f1s = []
        cnns = committee.active_cnn_members
        if cnns:
            probs = (_host(committee.predict_songs_cnn(
                self.data.store, split.test_songs, key))
                if cnn_probs is None else cnn_probs)
            for m, p in zip(cnns, probs):
                if not np.all(np.isfinite(p)):
                    committee.quarantine(
                        m.name, "non-finite eval probabilities")
                    continue
                f1s.append(report.model_eval(m.name, split.y_test_songs,
                                             p.argmax(axis=1)))
        for m in committee.active_host_members:
            try:
                y_pred = m.predict(split.X_test)
            except Exception as e:
                committee.quarantine(m.name, f"eval predict failed: {e!r}")
                continue
            f1s.append(report.model_eval(m.name, split.y_test_frames, y_pred))
        return f1s

    def _checkpoint(self, next_epoch: int, current_key) -> None:
        """Two-phase commit: stage the member files -> write the state
        (the commit point) -> promote.  Staging is synchronous (the members
        change in place at the next update); the state write and promotion
        run on the checkpointer's thread."""
        if not multihost.is_coordinator():
            return
        cfg, committee, split = self.config, self.committee, self.split
        user_path = self.user_path
        # join the previous commit first: its recover_workspace prunes
        # staging directories of other generations
        self.ckpt.wait()
        finish_members = committee.begin_save(
            al_state.staging_dir(user_path, next_epoch),
            reuse_dir=user_path, dtype=cfg.ckpt_dtype)
        kd, kdt = al_state.ALState.pack_key(current_key)
        state_obj = al_state.ALState(
            next_epoch=next_epoch, trajectory=list(self.trajectory),
            train_songs=[al_state.song_key(s) for s in split.train_songs],
            test_songs=[al_state.song_key(s) for s in split.test_songs],
            queried=[[al_state.song_key(s) for s in b]
                     for b in self.queried_hist],
            key_data=kd, key_dtype=kdt, mode=cfg.mode, seed=self.seed,
            queries=cfg.queries, train_size=cfg.train_size,
            member_weights=(dict(self.member_weights)
                            if self.acq.strategy.uses_weights else None),
        )
        bg_times = self.bg_times

        def commit():
            bg = finish_members()  # the CNN members' copies and files
            t0 = time.perf_counter()
            state_obj.save(user_path)  # the commit point
            al_state.recover_workspace(user_path)  # promote the stage
            bg["commit_s"] = time.perf_counter() - t0
            bg_times.update(bg)

        self.ckpt.submit(commit)
        self.ckpt_epoch = next_epoch

    def end_iteration_span(self, **attrs) -> None:
        """End the current iteration's ``al_iter`` span, if one is open.
        The scheduler calls this when it releases the session (at a
        fence's checkpoint, or an evict's step): the generator is closed
        there, before its own end of the span, and the iteration's host
        step spans would name a parent that is never written."""
        if self.trace_ctx is not None:
            self.tracer.end(self.trace_ctx, **attrs)
            self.trace_ctx = self.trace_epoch = None

    def _join_and_drain(self) -> None:
        """Join the previous background checkpoint in its own phase and
        record its self-timed parts (``ckpt_bg_fetch``, ``_write``,
        ``_commit``; they overlapped the iteration, so they are not part
        of its wall clock)."""
        with self.timer.phase("ckpt_join"):
            self.ckpt.wait()
        for k in ("fetch", "write", "commit"):
            if f"{k}_s" in self.bg_times:
                self.timer.add(f"ckpt_bg_{k}", self.bg_times.pop(f"{k}_s"))

    def _preempt_check(self, boundary: str) -> None:
        # agreed across processes, so every one leaves at this boundary
        if self.preemption is not None and multihost.broadcast_flag(
                bool(self.preemption.requested)):
            self.ckpt.wait()
            raise Preempted(
                f"preempted after {boundary}; workspace committed - "
                "rerun to resume at the next iteration")

    def _host_step(self, fn, label: str, offload: bool):
        """``fn()``'s value, computed on a host worker (a yielded
        :class:`HostStep`) when ``offload``, else inline."""
        if offload:
            return (yield HostStep(self, fn, label))
        return fn()

    def _eval_forward(self, key):
        """The evaluation's CNN forward as numpy, on the generator's
        thread: a stacked :class:`DeviceStep` when the committee stages an
        eval plan, else inline; ``None`` without ``cnn_steps`` (the
        evaluation then runs its own forward)."""
        committee, split, store = self.committee, self.split, self.data.store
        if not (self.cnn_steps and committee.active_cnn_members):
            return None
        plan = committee.eval_plan(store, split.test_songs, key)

        def single():
            return committee.predict_songs_cnn(store, split.test_songs, key)

        with self.timer.phase("evaluate"):
            block = (single() if plan is None else
                     (yield DeviceStep(self, plan, single, plan.fn_key)))
            return _host(block)

    def steps(self):
        """The iteration generator; returns the ``run_user`` result dict
        through ``StopIteration.value``."""
        from consensus_entropy_tpu_torch.al.loop import query_batch

        cfg, committee, data = self.config, self.committee, self.data
        split, acq, timer = self.split, self.acq, self.timer
        trajectory, queried_hist = self.trajectory, self.queried_hist
        seed = self.seed

        with self.ckpt, UserReport(
                self.user_path, cfg.mode,
                write=multihost.is_coordinator()) as report:
            #: host members' F1s from the last evaluation, the gate's
            #: before-scores (None: recompute)
            last_host_f1s = None

            def drain_events(epoch: int) -> list:
                events = committee.drain_quarantine_events()
                for ev in events:
                    report.quarantine_event(epoch, ev)
                return events

            def finish(epoch, f1s, **summary):
                """Close an evaluation: the quarantine events, the epoch's
                summary and the trajectory; returns the host members' F1s
                (``None`` when the member set shifted)."""
                f1_prev = (None if drain_events(epoch) else
                           f1s[len(committee.active_cnn_members):])
                report.epoch_summary(epoch, f1s, **summary)
                trajectory.append(float(np.mean(f1s)))
                return f1_prev

            uid = str(data.user_id)
            uctx = self.tracer.user_ctx(uid)
            if self._fresh:
                # epoch 0: baseline evaluation (amg_test.py:398-418)
                ictx = self.tracer.begin("al_iter", parent=uctx,
                                         key=(uid, -1), user=uid, epoch=-1)
                self.trace_ctx, self.trace_epoch = ictx, -1
                report.epoch_header(-1)
                self.key, sub = _split(self.key)
                eval_block = yield from self._eval_forward(sub)

                def baseline(sub=sub, block=eval_block):
                    with timer.phase("evaluate"):
                        f1s = self._evaluate(report, sub, cnn_probs=block)
                    return finish(-1, f1s)

                last_host_f1s = yield from self._host_step(
                    baseline, "baseline", self.sklearn_offloadable)

                def boundary0():
                    self._join_and_drain()
                    with timer.phase("checkpoint"):
                        self._checkpoint(0, self.key)
                    timer.flush(user=str(data.user_id), epoch=-1)

                yield from self._host_step(boundary0, "checkpoint",
                                           self.boundary_offloadable)
                # the span closes before the preemption boundary: a resume
                # after a clean preemption starts at the next iteration
                self.tracer.end(ictx)
                self.trace_ctx = self.trace_epoch = None
                self._preempt_check("baseline evaluation")

            for epoch in range(self.start_epoch, cfg.epochs):
                report.epoch_header(epoch)
                live = acq.remaining_songs
                if len(live) == 0:
                    break
                ictx = self.tracer.begin("al_iter", parent=uctx,
                                         key=(uid, epoch), user=uid,
                                         epoch=epoch)
                self.trace_ctx, self.trace_epoch = ictx, epoch
                member_probs = None
                block = plan = None
                strat = acq.strategy
                if strat.needs_probs:
                    self.key, sub = _split(self.key)
                    if strat.uses_weights:
                        acq.member_weights = self._weights_vector()
                    width = acq.staging_width(len(live))

                    # a pure pass (fixed crop and mask keys): a transient
                    # error retries it; the producer is the strategy's
                    def produce(live=live, sub=sub, cnn_only=False):
                        if strat.probs_source == "qbdc":
                            return committee.qbdc_pool_probs(
                                data.store, live, sub, k=cfg.qbdc_k,
                                pad_to=width)
                        if cnn_only:
                            return committee.predict_songs_cnn(
                                data.store, live, sub, pad_to=width)
                        return committee.pool_probs(
                            data.pool, live, pad_to=width, store=data.store,
                            key=sub)

                    def score(epoch=epoch, cnn_only=False):
                        return retry_transient(
                            lambda: faults.fire(
                                "pool.score", payload=produce(
                                    cnn_only=cnn_only)),
                            attempts=cfg.retry_attempts,
                            base_delay=cfg.retry_base_delay,
                            seed=seed + epoch, what="pool.score")

                    if self.cnn_steps:
                        plan = strat.probs_plan(committee, data.store, live,
                                                sub, pad_to=width, config=cfg)
                    with timer.phase("score"):
                        if plan is not None:
                            # the CNN block; the host members' block and
                            # the merge follow in the select phase
                            block = yield DeviceStep(
                                self, plan, lambda: score(cnn_only=True),
                                plan.fn_key)
                        else:
                            member_probs = yield from self._host_step(
                                score, "score", self.host_offloadable)

                def weight_fixup():
                    # a member quarantined during this pass keeps its
                    # (NaN'd, then sanitized) probs row: zero its weight so
                    # it cannot re-enter the weighted consensus
                    if not (strat.uses_weights and committee.quarantined):
                        return
                    w = np.asarray(acq.member_weights, np.float32).copy()
                    for i, nm in enumerate(self._scoring_member_names or []):
                        if nm in committee.quarantined:
                            w[i] = 0.0
                    acq.member_weights = w

                if plan is None:
                    weight_fixup()
                self.key, sub = _split(self.key)
                with timer.phase("select"):
                    if plan is not None:
                        if strat.probs_source == "qbdc":
                            member_probs = block
                        else:
                            # the host members' predicts (numpy) ride the
                            # pool; the merge stays on this thread
                            host_block = yield from self._host_step(
                                lambda live=live, w=plan.pad_to:
                                committee.host_block(data.pool, live, w),
                                "select", self.sklearn_offloadable)
                            member_probs = committee.merge_blocks(
                                block, host_block)
                        weight_fixup()
                    fn_key, inputs = acq.scoring_inputs(member_probs,
                                                        rand_key=sub)
                    res = yield ScoreStep(self, fn_key, inputs)
                    q_songs = acq.finish_select(res)

                # only wmc reads the probs table after the select
                weight_probs = (_host(member_probs) if strat.uses_weights
                                else None)
                del member_probs, block

                # the update's and an unstacked retrain's spans go under
                # the iteration's; untraced, the two-argument update call
                # that ``benchmark.faults`` may stand in for
                trace = (dict(tracer=self.tracer, parent=self.trace_ctx,
                              user=uid) if self.tracer.enabled else {})

                def reveal_update(q_songs=q_songs, before=last_host_f1s,
                                  probs=weight_probs, live=live,
                                  trace=trace):
                    # reveal the labels, build the batch
                    # (amg_test.py:491-493)
                    X_batch, y_batch = query_batch(data.pool, data.labels,
                                                   q_songs)
                    if strat.uses_weights:
                        self._update_member_weights(probs, live, q_songs)
                    with timer.phase("update_host"):
                        if cfg.gate_host_updates and len(split.X_test):
                            committee.update_host_gated(
                                X_batch, y_batch, split.X_test,
                                split.y_test_frames, before_scores=before,
                                **trace)
                        else:
                            committee.update_host(X_batch, y_batch,
                                                  **trace)

                y_q = one_hot_np([data.labels[s] for s in q_songs])
                y_t = one_hot_np(split.y_test_songs)

                def retrain(sub, q_songs=q_songs, y_q=y_q, epoch=epoch,
                            trace=trace):
                    # fit_many rebinds the members' variables only on
                    # return, so a retry replays the identical fit
                    return retry_transient(
                        lambda: committee.retrain_cnns(
                            data.store, q_songs, y_q, split.test_songs, y_t,
                            sub, n_epochs=self.retrain_epochs, **trace),
                        attempts=cfg.retry_attempts,
                        base_delay=cfg.retry_base_delay,
                        seed=seed + 7919 * (epoch + 1),
                        what="member.retrain")

                summary = dict(queried=q_songs,
                               pool_size=len(acq.remaining_songs))
                if self.cnn_steps:
                    yield from self._host_step(
                        reveal_update, "update_host",
                        self.sklearn_offloadable
                        and bool(committee.active_host_members))
                    if committee.active_cnn_members:
                        self.key, sub = _split(self.key)
                        rplan = committee.retrain_plan(
                            data.store, q_songs, y_q, split.test_songs, y_t,
                            sub, n_epochs=self.retrain_epochs, user=uid)
                        with timer.phase("retrain_cnn"):
                            if rplan is None:
                                retrain(sub)
                            else:
                                yield DeviceStep(self, rplan,
                                                 lambda sub=sub: retrain(sub),
                                                 rplan.fn_key)
                    self.key, sub = _split(self.key)
                    eval_block = yield from self._eval_forward(sub)

                    def eval_epoch(sub=sub, block=eval_block,
                                   epoch=epoch, summary=summary):
                        with timer.phase("evaluate"):
                            f1s = self._evaluate(report, sub,
                                                 cnn_probs=block)
                        return finish(epoch, f1s, **summary)

                    last_host_f1s = yield from self._host_step(
                        eval_epoch, "evaluate", self.sklearn_offloadable)
                else:
                    def update_and_eval(epoch=epoch, summary=summary):
                        reveal_update()
                        if committee.active_cnn_members:
                            self.key, sub = _split(self.key)
                            with timer.phase("retrain_cnn"):
                                retrain(sub)
                        self.key, sub = _split(self.key)
                        with timer.phase("evaluate"):
                            f1s = self._evaluate(report, sub)
                        return finish(epoch, f1s, **summary)

                    last_host_f1s = yield from self._host_step(
                        update_and_eval, "update_eval",
                        self.host_offloadable)

                # per-iteration persistence (amg_test.py:511) + resume state
                queried_hist.append(q_songs)

                def boundary(epoch=epoch, q_songs=q_songs):
                    self._join_and_drain()
                    with timer.phase("checkpoint"):
                        self._checkpoint(epoch + 1, self.key)
                    timer.flush(user=str(data.user_id), epoch=epoch,
                                queried=len(q_songs))

                yield from self._host_step(boundary, "checkpoint",
                                           self.boundary_offloadable)
                self.tracer.end(ictx, queried=len(q_songs))
                self.trace_ctx = self.trace_epoch = None
                self._preempt_check(f"iteration {epoch}")

            result = {"user": data.user_id, "mode": cfg.mode,
                      "trajectory": trajectory,
                      "final_mean_f1": trajectory[-1] if trajectory
                      else None}
        # every write is durable here; the barrier keeps the other
        # processes from reading the workspace before the last commit
        multihost.sync(f"run_user_done_{data.user_id}")
        self.result = result
        return result
