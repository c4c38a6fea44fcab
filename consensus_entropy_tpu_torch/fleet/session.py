"""The per-user AL loop as a steppable coroutine.

Counterpart of ``consensus_entropy_tpu/fleet/session.py:63-940``,
sequential path: committees of host members (scored on the host, or
through the device slice with ``device_members``) and CNN members (the
test-split CNN forward in the evaluation, the CNN block of the mc score,
the qbdc producer, the ``retrain_cnn`` phase; ``:353-372, 540-560,
630-712, 876-905``).  ``UserSession.steps`` is a generator that yields a
:class:`ScoreStep` for the staged scoring call (``Acquirer.
scoring_inputs``) and runs the rest inline.  The sequential runner,
:func:`drive_inline`, answers each step with its result, so a run executes
the statements of the JAX session in the same order with the same per-user
key stream (one ``prng.split`` for each ``jax.random.split``), with and
without CNN members.  The offload protocol (``HostStep``) and the
batchable CNN device steps (``DeviceStep`` and its plans) come back with
the fleet scheduler (ROADMAP A9); the span tracer and the multi-host
barriers wait for A10 and A11.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.al import state as al_state
from consensus_entropy_tpu_torch.al.acquisition import Acquirer
from consensus_entropy_tpu_torch.al.reporting import UserReport
from consensus_entropy_tpu_torch.config import ALConfig
from consensus_entropy_tpu_torch.labels import one_hot_np
from consensus_entropy_tpu_torch.obs.metrics import StepTimer
from consensus_entropy_tpu_torch.resilience import faults
from consensus_entropy_tpu_torch.resilience.preemption import Preempted
from consensus_entropy_tpu_torch.resilience.retry import retry_transient


@dataclasses.dataclass
class ScoreStep:
    """Request: run ``session.acq``'s staged scoring call and answer with
    its result."""

    session: "UserSession"
    fn_key: str
    inputs: tuple


def drive_inline(session: "UserSession") -> dict:
    """Service a session synchronously: the sequential ``run_user``.  A
    servicer failure is thrown into the generator, so the session's own
    error path (checkpointer joined, report closed) runs before the error
    propagates."""
    gen = session.steps()
    try:
        step = next(gen)
        while True:
            try:
                value = step.session.acq.run_scoring(step.fn_key,
                                                     step.inputs)
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


class UserSession:
    """One user's AL run, initialized as ``run_user`` would: resume state,
    split, acquirer and checkpointer; :meth:`steps` is the iteration
    generator.  ``device`` is where the acquisition runs (``None`` is the
    card); the per-user key stream stays on the host."""

    def __init__(self, config: ALConfig, committee, data, user_path: str, *,
                 seed: int | None = None, tie_break: str = "fast",
                 retrain_epochs: int | None = None,
                 pad_pool_to: int | None = None, resume: bool = True,
                 timer: StepTimer | None = None, preemption=None,
                 fuse_step: bool = True, device=None):
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
        self.result: dict | None = None
        # the config's survivor floor never weakens a stricter committee
        committee.min_members = max(committee.min_members, cfg.min_members)
        #: wmc: per-member reliability weights by member name, persisted
        #: in ALState so a resumed run replays them
        self.member_weights: dict = {}
        #: the member-name order of the last scoring pass's probs axis
        self._scoring_member_names: list | None = None

        st = al_state.ALState.load(user_path) if resume else None
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

        hc_rows = None
        if data.hc_rows is not None:
            rows = data.pool.row_of(self.split.train_songs)
            hc_rows = np.asarray(data.hc_rows)[rows]
        self.acq = Acquirer(self.split.train_songs, hc_rows,
                            queries=cfg.queries, mode=cfg.mode,
                            tie_break=tie_break, seed=self.seed,
                            pad_to=pad_pool_to, fuse_step=fuse_step,
                            device=device)
        self.acq.replay(self.queried_hist)
        self.ckpt = AsyncCheckpointer()
        #: the last finished background job's self-timed durations
        self.bg_times: dict = {}

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

    def _evaluate(self, report: UserReport, key) -> list[float]:
        """F1 of every active member on the test split, committee order
        (CNN members first, each on one random crop a test song under
        ``key``); a member whose predict raises or whose CNN probabilities
        go non-finite is quarantined and left out."""
        committee, split = self.committee, self.split
        f1s = []
        cnns = committee.active_cnn_members
        if cnns:
            probs = committee.predict_songs_cnn(
                self.data.store, split.test_songs, key).cpu().numpy()
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
        if self.preemption is not None and self.preemption.requested:
            self.ckpt.wait()
            raise Preempted(
                f"preempted after {boundary}; workspace committed - "
                "rerun to resume at the next iteration")

    def steps(self):
        """The iteration generator; returns the ``run_user`` result dict
        through ``StopIteration.value``."""
        from consensus_entropy_tpu_torch.al.loop import query_batch

        cfg, committee, data = self.config, self.committee, self.data
        split, acq, timer = self.split, self.acq, self.timer
        trajectory, queried_hist = self.trajectory, self.queried_hist
        seed = self.seed

        with self.ckpt, UserReport(self.user_path, cfg.mode) as report:
            #: host members' F1s from the last evaluation, the gate's
            #: before-scores (None: recompute)
            last_host_f1s = None

            def drain_events(epoch: int) -> list:
                events = committee.drain_quarantine_events()
                for ev in events:
                    report.quarantine_event(epoch, ev)
                return events

            if self._fresh:
                # epoch 0: baseline evaluation (amg_test.py:398-418)
                report.epoch_header(-1)
                self.key, sub = _split(self.key)
                with timer.phase("evaluate"):
                    f1s = self._evaluate(report, sub)
                last_host_f1s = (None if drain_events(-1) else
                                 f1s[len(committee.active_cnn_members):])
                report.epoch_summary(-1, f1s)
                trajectory.append(float(np.mean(f1s)))
                self._join_and_drain()
                with timer.phase("checkpoint"):
                    self._checkpoint(0, self.key)
                timer.flush(user=str(data.user_id), epoch=-1)
                self._preempt_check("baseline evaluation")

            for epoch in range(self.start_epoch, cfg.epochs):
                report.epoch_header(epoch)
                live = acq.remaining_songs
                if len(live) == 0:
                    break
                member_probs = None
                strat = acq.strategy
                if strat.needs_probs:
                    self.key, sub = _split(self.key)
                    if strat.uses_weights:
                        acq.member_weights = self._weights_vector()

                    # a pure pass (fixed crop and mask keys): a transient
                    # error retries it; the producer is the strategy's
                    def produce(live=live, sub=sub):
                        if strat.probs_source == "qbdc":
                            return committee.qbdc_pool_probs(
                                data.store, live, sub, k=cfg.qbdc_k,
                                pad_to=acq.staging_width(len(live)))
                        return committee.pool_probs(
                            data.pool, live,
                            pad_to=acq.staging_width(len(live)),
                            store=data.store, key=sub)

                    with timer.phase("score"):
                        member_probs = retry_transient(
                            lambda: faults.fire("pool.score",
                                                payload=produce()),
                            attempts=cfg.retry_attempts,
                            base_delay=cfg.retry_base_delay,
                            seed=seed + epoch, what="pool.score")
                # a member quarantined during this pass keeps its (NaN'd,
                # then sanitized) probs row: zero its weight so it cannot
                # re-enter the weighted consensus
                if strat.uses_weights and committee.quarantined:
                    w = np.asarray(acq.member_weights, np.float32).copy()
                    for i, nm in enumerate(self._scoring_member_names or []):
                        if nm in committee.quarantined:
                            w[i] = 0.0
                    acq.member_weights = w
                self.key, sub = _split(self.key)
                with timer.phase("select"):
                    fn_key, inputs = acq.scoring_inputs(member_probs,
                                                        rand_key=sub)
                    res = yield ScoreStep(self, fn_key, inputs)
                    q_songs = acq.finish_select(res)

                # reveal the labels, build the batch (amg_test.py:491-493)
                X_batch, y_batch = query_batch(data.pool, data.labels,
                                               q_songs)
                if strat.uses_weights:
                    self._update_member_weights(member_probs, live, q_songs)
                with timer.phase("update_host"):
                    if cfg.gate_host_updates and len(split.X_test):
                        committee.update_host_gated(
                            X_batch, y_batch, split.X_test,
                            split.y_test_frames, before_scores=last_host_f1s)
                    else:
                        committee.update_host(X_batch, y_batch)
                if committee.active_cnn_members:
                    y_q = one_hot_np([data.labels[s] for s in q_songs])
                    y_t = one_hot_np(split.y_test_songs)
                    self.key, sub = _split(self.key)
                    with timer.phase("retrain_cnn"):
                        # fit_many rebinds the members' variables only on
                        # return, so a retry replays the identical fit
                        retry_transient(
                            lambda sub=sub, y_q=y_q, y_t=y_t, q=q_songs:
                            committee.retrain_cnns(
                                data.store, q, y_q, split.test_songs, y_t,
                                sub, n_epochs=self.retrain_epochs),
                            attempts=cfg.retry_attempts,
                            base_delay=cfg.retry_base_delay,
                            seed=seed + 7919 * (epoch + 1),
                            what="member.retrain")
                self.key, sub = _split(self.key)
                with timer.phase("evaluate"):
                    f1s = self._evaluate(report, sub)
                last_host_f1s = (None if drain_events(epoch) else
                                 f1s[len(committee.active_cnn_members):])
                report.epoch_summary(epoch, f1s, queried=q_songs,
                                     pool_size=len(acq.remaining_songs))
                trajectory.append(float(np.mean(f1s)))

                # per-iteration persistence (amg_test.py:511) + resume state
                queried_hist.append(q_songs)
                self._join_and_drain()
                with timer.phase("checkpoint"):
                    self._checkpoint(epoch + 1, self.key)
                timer.flush(user=str(data.user_id), epoch=epoch,
                            queried=len(q_songs))
                self._preempt_check(f"iteration {epoch}")

            result = {"user": data.user_id, "mode": cfg.mode,
                      "trajectory": trajectory,
                      "final_mean_f1": trajectory[-1] if trajectory
                      else None}
        self.result = result
        return result
