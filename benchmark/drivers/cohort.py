"""The ``cohort`` traffic: a closed loop of AL users on one
``FleetScheduler``, the engine ``amg_test --fleet N`` runs.

``users`` sessions are live at once; each starts its next iteration when
its last one ends, and a user who finishes its ``epochs`` iterations is
replaced at once by the next prepared user, so the cohort stays full.
Set-up makes the inputs (``benchmark.inputs``), opens the engine, admits
the first users and runs each one's baseline evaluation and first
iteration (the warm-up: every shape the window uses, since the pool's
staging width, the crop bucket, the retrain's batches and the window
chunks do not change from one iteration to the next).  The window then
runs for ``seconds``; the iterations still running at its close are
waited for (``benchmark.stats``' window rule needs their lengths), and
the engine is stopped.

Iteration starts and ends are read from the sessions' own ``al_iter``
spans, through a tracer that records only them unless the run is traced.
At each iteration start from the warm-up's last round on, a copy of the
committee is kept for the correctness check (``benchmark.check``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
import traceback
import types

import torch

from benchmark import check, flops, inputs, stats
from benchmark.reference.trunk import TrunkConfig


class _Token:
    """The open iteration of an untraced run."""


def make_clock(enabled: bool):
    from consensus_entropy_tpu_torch.obs.trace import Tracer

    class IterClock(Tracer):
        """The sessions' tracer: records each ``al_iter`` span's user,
        epoch, start and end (unix-epoch s) in ``iters`` and calls
        ``on_begin`` at each start; with ``enabled`` it also keeps every
        span in memory (``records``), as the port's ``Tracer`` does."""

        def __init__(self):
            super().__init__(None, run_id="benchmark", enabled=enabled)
            self.iters: list = []
            self.on_begin = None
            self._open: dict = {}

        def begin(self, name, *, parent=None, key=None, **attrs):
            sp = super().begin(name, parent=parent, key=key, **attrs)
            if name != "al_iter":
                return sp
            rec = {"user": str(attrs["user"]), "epoch": int(attrs["epoch"]),
                   "t0": time.time(), "t1": None}
            if self.on_begin is not None:
                self.on_begin(rec)
            self.iters.append(rec)
            token = _Token() if sp is None else sp
            self._open[id(token)] = (token, rec)
            return token

        def end(self, span, **attrs):
            hit = self._open.pop(id(span), None)
            if hit is not None:
                hit[1]["t1"] = time.time()
            if not isinstance(span, _Token):
                super().end(span, **attrs)

    return IterClock()


def window_work(cfg: dict, traffic: dict, iters, t0, t1) -> flops.Work:
    """The CNN work the window's share of each iteration needs (the
    window rule's shares; a baseline evaluation counts too)."""
    tcfg = TrunkConfig.from_dict(cfg["cnn"])
    n_songs = cfg["user"]["songs"]
    n_train = int(round(cfg["user"]["train_size"] * n_songs))
    n_test = n_songs - n_train
    m = cfg["members"]["cnn"]
    hop = traffic["full_song_hop"]
    samples = cfg["store"]["seconds"] * cfg["store"]["sample_rate"]
    windows = 1 if hop is None else (samples - tcfg.input_length) // hop + 1
    score_batch = 256 if hop is None else 8 * windows
    out = flops.Work()
    for it in iters:
        if it.get("t1") is None or it["t1"] <= it["t0"]:
            continue
        share = (min(it["t1"], t1) - max(it["t0"], t0)) / (it["t1"]
                                                           - it["t0"])
        if share <= 0:
            continue
        if it["epoch"] < 0:
            w = flops.baseline_work(tcfg, members=m, n_test=n_test)
        else:
            w = flops.iteration_work(
                tcfg, members=m,
                n_live=n_train - traffic["queries"] * it["epoch"],
                n_train_q=traffic["queries"], n_test=n_test,
                retrain_epochs=cfg["retrain_epochs"], windows=windows,
                score_batch=score_batch,
                batch_size=cfg["train"]["batch_size"])
        out.add(w, share)
    return out


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print) -> dict:
    """One run of a cohort cell; returns what ``benchmark.run`` prints."""
    from consensus_entropy_tpu_torch.data.audio import DeviceWaveformStore
    from consensus_entropy_tpu_torch.fleet.report import FleetReport
    from consensus_entropy_tpu_torch.fleet.scheduler import (
        FleetScheduler,
        FleetUser,
    )

    from benchmark.trace import DeviceTrace

    cfg, tr = cell.config, cell.traffic
    on_card = str(device).startswith("cuda")
    log(f"[benchmark] imports done {time.time() - t_start:.1f} s")
    inp = inputs.build(cfg, tr, seed, device)
    if on_card:
        torch.cuda.synchronize()
    log(f"[benchmark] inputs made {time.time() - t_start:.1f} s")
    cnn_cfg, al_cfg = inputs.program_configs(cfg, tr)
    store = DeviceWaveformStore.from_padded(
        inp.ids, inp.data,
        torch.full((len(inp.ids),), inp.data.shape[1], device=device),
        cnn_cfg.input_length)
    root = tempfile.mkdtemp(prefix="benchmark-")
    clock = make_clock(trace)
    report = FleetReport()
    sched = FleetScheduler(al_cfg, retrain_epochs=cfg["retrain_epochs"],
                           report=report, tracer=clock, device=device)
    pending = list(inp.users)
    users: dict = {}  # user id -> (User, FleetUser, workspace)
    live: list = []
    snaps: dict = {}
    window = {"t0": None, "snap_s": 0.0}

    def on_begin(rec):
        # the first users' iteration 0 ends before the window opens
        if rec["epoch"] < 0 or (window["t0"] is None and rec["epoch"] == 0):
            return
        c0 = time.perf_counter()
        snaps[(rec["user"], rec["epoch"])] = check.snapshot(
            users[rec["user"]][1].committee)
        window["snap_s"] += time.perf_counter() - c0

    clock.on_begin = on_begin

    def admit():
        if not pending:
            raise RuntimeError("the prepared users ran out: raise the "
                               "traffic's spare_users")
        u = pending.pop(0)
        path = os.path.join(root, u.user_id)
        os.makedirs(path)
        entry = FleetUser(u.user_id, inputs.committee(inp, cfg, tr, device),
                          inputs.user_data(inp, u, store), path, seed=u.seed)
        users[u.user_id] = (u, entry, path)
        live.append(u.user_id)
        sched.admit(entry, pad=cfg["user"]["songs"])

    def pump():
        if not sched.pump():
            raise RuntimeError("the engine went idle with users live")

    def ended(uid, epoch):
        return any(r["user"] == uid and r["epoch"] == epoch
                   and r["t1"] is not None for r in clock.iters)

    failed, finals = [], {}

    def retire(admitting: bool):
        for uid in list(live):
            rec = sched.results.get(id(users[uid][1]))
            if rec is None:
                continue
            live.remove(uid)
            if rec["error"] is not None:
                failed.append((uid, rec["error"]))
                log(f"[benchmark] user {uid} failed: {rec['error']}")
            done = [r["epoch"] for r in clock.iters
                    if r["user"] == uid and r["t1"] is not None]
            if done and rec["error"] is None:
                finals[uid] = (max(done),
                               check.snapshot(users[uid][1].committee))
            if admitting:
                admit()

    sched.open(tr["users"])
    try:
        for _ in range(tr["users"]):
            admit()
        first = list(live)
        while not all(ended(uid, -1) for uid in first):
            pump()
        log(f"[benchmark] baselines done {time.time() - t_start:.1f} s")
        while not all(ended(uid, 0) for uid in first):
            pump()
        if on_card:
            torch.cuda.synchronize()
        t0 = time.time()
        setup_s = t0 - t_start
        window["t0"] = t0
        t1 = t0 + seconds
        dtrace = DeviceTrace() if trace else None
        if dtrace is not None:
            dtrace.start()
        while time.time() < t1:
            pump()
            retire(admitting=True)
        # the iterations running at the close: wait for their ends
        while any(r["t1"] is None and r["t0"] < t1 and r["user"] in live
                  for r in clock.iters):
            pump()
            retire(admitting=False)
        retire(admitting=False)
        log(f"[benchmark] window closed, running iterations ended "
            f"{time.time() - t1:.1f} s after it")
        trace_data = None
        if dtrace is not None:
            c0 = time.time()
            dtrace.stop()
            try:
                trace_data = dtrace.reduce(t1)
            except Exception:  # the run's other results stand
                log("[benchmark] the trace could not be read:\n"
                    + traceback.format_exc())
            else:
                log(f"[benchmark] trace stopped and read in "
                    f"{time.time() - c0:.1f} s: {len(trace_data.kernels)} "
                    f"device events, "
                    f"{sum(k.launch is not None for k in trace_data.kernels)}"
                    f" matched to their launch")
    except BaseException:
        sched.abort()
        shutil.rmtree(root, ignore_errors=True)
        raise
    finally:
        sched.close()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    n_iter, mean_s = stats.window_iterations(clock.iters, t0, t1)
    attempted = sum(1 for r in clock.iters if r["epoch"] >= 0
                    and r["t0"] < t1 and (r["t1"] or t1) > t0)
    log(f"[benchmark] window {seconds} s: {n_iter:.4f} iterations by the "
        f"window rule, {attempted} overlapping it, mean length "
        f"{mean_s}; committee copies {window['snap_s']:.3f} s; users "
        f"admitted {len(users)}")
    ctx = types.SimpleNamespace(
        window=(t0, t1), seconds=seconds, iterations=n_iter,
        mean_s=mean_s, setup_s=setup_s,
        iters=clock.iters, report=report, spans=clock.records,
        trace=trace_data, config=cfg, traffic=tr,
        work=window_work(cfg, tr, clock.iters, t0, t1))
    in_window = {(r["user"], r["epoch"]) for r in clock.iters
                 if r["epoch"] >= 0 and r["t0"] < t1
                 and (r["t1"] is None or r["t1"] > t0)}
    return {"attempted": attempted, "failed": len(failed),
            "memory_peak_bytes": peak, "ctx": ctx,
            "check_args": (inp, {u: (v[0], v[2]) for u, v in users.items()},
                           snaps, finals, in_window),
            "free": lambda: _free(users),
            "cleanup": lambda: shutil.rmtree(root, ignore_errors=True)}


def _free(users: dict) -> None:
    """Drop the system under test's state (its workspaces stay until the
    check has read them)."""
    for _, entry, _ in users.values():
        entry.committee = entry.data = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
