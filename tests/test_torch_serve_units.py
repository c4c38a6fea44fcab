"""The port's serve-layer units against the JAX package's, on the CPU.

Pure host code, so every comparison is exact: bucket routing and edge
validation, the admission queue (bound, priority, the aging guard and the
slot reserve driven through its clock seam), ``ServeConfig`` validation,
the breaker's state machine on a fake clock, the watchdog's deadlines, and
the decision tables of ``derive_edges``, ``admission_hold`` and
``dispatch_hold`` over a seeded grid, each equal to the JAX package's."""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.obs.metrics import QuantileSketch as JaxSketch
from consensus_entropy_tpu.serve import breaker as jax_breaker
from consensus_entropy_tpu.serve import buckets as jax_buckets
from consensus_entropy_tpu.serve import planner as jax_planner
from consensus_entropy_tpu.serve import server as jax_server
from consensus_entropy_tpu_torch.obs.metrics import QuantileSketch
from consensus_entropy_tpu_torch.serve import (
    AdmissionQueue,
    BucketRouter,
    DispatchBreaker,
    QueueClosed,
    QueueFull,
    ServeConfig,
    Watchdog,
    WatchdogTimeout,
    admission_hold,
    derive_edges,
    dispatch_hold,
    validate_bucket_widths,
)
from consensus_entropy_tpu_torch.serve.buckets import next_pow2

torch.set_num_threads(1)


def test_bucket_routing_equals_jax():
    for widths in (None, (20, 64, 130), (8,), (1000,)):
        ours = BucketRouter(widths)
        theirs = jax_buckets.BucketRouter(widths)
        assert ours.widths == theirs.widths and repr(ours) == repr(theirs)
        for n in list(range(1, 300)) + [1023, 1024, 1025, 5000]:
            assert ours.width_for(n) == theirs.width_for(n)
    assert [next_pow2(n) for n in (1, 8, 9, 33)] == [8, 8, 16, 64]
    r = BucketRouter((16, 32))
    r.update((24, 48))
    assert r.width_for(20) == 24 and r.width_for(49) == 64


@pytest.mark.parametrize("widths", [(), (0, 8), (16, 8), (8, 8), (9, 12),
                                    (8, True), (8, 16.0)])
def test_bucket_width_validation_equals_jax(widths):
    with pytest.raises(ValueError) as ours:
        validate_bucket_widths(widths)
    with pytest.raises(ValueError) as theirs:
        jax_buckets.validate_bucket_widths(widths)
    # the port compiles no jit family: it names its per-width family
    assert str(ours.value) == str(theirs.value).replace("jit", "per-width")
    assert validate_bucket_widths([8, 24]) == (8, 24)


class _Entry:
    def __init__(self, uid, priority=None):
        self.user_id = uid
        if priority is not None:
            self.priority = priority


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_admission_queue_backpressure_priority_and_aging():
    clock = _Clock()
    q = AdmissionQueue(3, aging_s=10.0, clock=clock)
    q.put(_Entry("b0", "batch"))
    clock.t = 1.0
    q.put(_Entry("i0", "interactive"))
    q.put(_Entry("x0"))  # no class: the lowest
    with pytest.raises(QueueFull):
        q.put(_Entry("b1", "batch"))
    assert q.try_put(_Entry("b1", "batch")) is None
    assert q.depths() == {"interactive": 1, "batch": 2}
    assert q.head_waits() == {"interactive": 0.0, "batch": 1.0}
    # strict priority while nobody aged
    assert q.pop()[0].user_id == "i0"
    q.put(_Entry("i1", "interactive"))
    clock.t = 10.5  # b0 waited 10.5 s: it jumps the interactive head
    assert q.pop()[0].user_id == "b0"
    assert q.pop()[0].user_id == "i1"
    assert q.pop()[0].user_id == "x0"
    assert q.pop() is None and len(q) == 0
    assert q.remove("zz") is None
    q.put(_Entry("b2", "batch"))
    assert q.remove("b2").user_id == "b2"
    q.close()
    with pytest.raises(QueueClosed):
        q.put(_Entry("b3"))
    assert q.closed and not q.wait_nonempty(5.0)  # close wakes at once


def test_queue_slot_and_bound_reserves_equal_jax():
    """The batch class's slot reserve and queue-bound share, the same pops
    and refusals as the JAX queue's over one script."""
    outs = []
    for mod in (None, jax_server):
        cls = AdmissionQueue if mod is None else mod.AdmissionQueue
        q = cls(4, reserve={"batch": 1}, bound_reserve={"batch": 1},
                clock=_Clock())
        log = []
        for uid in ("i0", "i1", "i2", "i3"):
            try:
                q.put(_Entry(uid, "interactive"))
                log.append(("put", uid))
            except Exception as e:  # the JAX queue raises its own class
                log.append(("full", uid, type(e).__name__))
        q.put(_Entry("b0", "batch"))
        log.append(("pop", q.pop(live={"interactive": 2}, free=1)[0]
                    .user_id))
        log.append(("pop", q.pop(live={"interactive": 2, "batch": 1},
                                 free=1)[0].user_id))
        outs.append(log)
    assert outs[0] == outs[1]
    assert outs[0][3] == ("full", "i3", "QueueFull")
    assert outs[0][4] == ("pop", "b0")  # the last free slot is batch's


def test_queue_wait_at_least_wakes_on_put():
    q = AdmissionQueue(4)

    def later():
        time.sleep(0.05)
        q.put(_Entry("a"))
        q.put(_Entry("b"))

    t = threading.Thread(target=later)
    t.start()
    assert q.wait_at_least(2, 5.0)
    t.join()


@pytest.mark.parametrize("kw", [
    {"target_live": 0}, {"max_queue": 0}, {"bucket_widths": (16, 8)},
    {"mesh_devices": 0}, {"mesh_devices": 3},
    {"mesh_devices": 4, "bucket_widths": (8, 18)}, {"watchdog_s": -1},
    {"failure_budget": 0}, {"breaker_threshold": -1},
    {"breaker_probes": -1}, {"planner_epoch": 0}, {"planner_buckets": 0},
    {"slo_interactive_s": 0}, {"slo_batch_s": -1}, {"aging_s": -1},
    {"max_hold_s": -1}, {"batch_reserve": -1}])
def test_serve_config_validation_equals_jax(kw):
    with pytest.raises(ValueError) as ours:
        ServeConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        jax_server.ServeConfig(**kw)
    assert str(ours.value) == str(theirs.value)


def test_serve_config_accepts_what_jax_accepts():
    ok = dict(target_live=2, bucket_widths=(16, 32), mesh_devices=2)
    assert ServeConfig(**ok).bucket_widths == \
        jax_server.ServeConfig(**ok).bucket_widths == (16, 32)


def _breaker_script(cls):
    clock = _Clock()
    b = cls(2, 5.0, probe_budget=2, clock=clock)
    log = []
    for t, op in ((0, "allow"), (0, "fail"), (0, "allow"), (0, "fail"),
                  (1, "allow"), (6, "allow"), (6, "allow"), (6, "fail"),
                  (12, "allow"), (12, "ok"), (12, "fail"), (12, "fail"),
                  (20, "allow"), (20, "fail"), (26, "allow"),
                  (26, "fail"), (40, "allow")):
        clock.t = t
        if op == "allow":
            log.append((op, b.allow_stacked(32), b.state_of(32)))
        elif op == "ok":
            log.append((op, b.record_success(32), b.state_of(32)))
        else:
            log.append((op, b.record_failure(32), b.state_of(32)))
    log.append(("summary", b.summary(), b.trips, b.state_of(64)))
    return log


def test_breaker_state_machine_equals_jax():
    ours = _breaker_script(DispatchBreaker)
    assert ours == _breaker_script(jax_breaker.DispatchBreaker)
    states = [s for _, _, s in ours[:-1]]
    assert "open" in states and "half_open" in states
    assert ours[-2] == ("allow", False, "gave_up")
    for bad in ({"threshold": 0}, {"cooldown_s": 0},
                {"probe_budget": -1}):
        with pytest.raises(ValueError):
            DispatchBreaker(**bad)


def test_watchdog_deadlines_and_calls():
    clock = _Clock()
    wd = Watchdog(2.0, clock=clock)
    wd.arm("s1", "update_host")
    clock.t = 1.0
    wd.arm("s2")
    assert wd.expired() == [] and wd.poll_s() == 1.0
    clock.t = 2.5
    assert wd.expired() == [("s1", "update_host", 2.5)]
    exc = wd.trip("s1", "update_host", 2.5)
    assert isinstance(exc, WatchdogTimeout) and wd.trips == 1
    assert "update_host" in str(exc) and wd.expired() == []
    wd.disarm("s2")
    assert wd.poll_s() == 2.0
    real = Watchdog(0.2)
    assert real.call(lambda: 5, "x") == 5
    with pytest.raises(ZeroDivisionError):
        real.call(lambda: 1 / 0, "x")
    with pytest.raises(WatchdogTimeout, match="hang"):
        real.call(lambda: time.sleep(2), "hang")
    assert real.trips == 1
    with pytest.raises(ValueError):
        Watchdog(0)


def test_planner_decision_tables_equal_jax():
    rng = np.random.default_rng(2026)
    for trial in range(40):
        n = int(rng.integers(1, 400))
        sizes = rng.integers(1, int(rng.integers(2, 3000)), n)
        ours, theirs = QuantileSketch(max_samples=int(
            rng.choice([64, 4096]))), None
        theirs = JaxSketch(max_samples=ours.max_samples)
        for v in sizes:
            ours.add(int(v))
            theirs.add(int(v))
        for nb in (1, 2, 4, 7):
            assert derive_edges(ours, n_buckets=nb) == \
                jax_planner.derive_edges(theirs, n_buckets=nb)
    assert derive_edges(QuantileSketch()) == ()
    grid = itertools.product((0, 1, 3, 6), (0, 2, 6), (None, 0.0, 0.3, 5.0),
                             (-1.0, 0.0, 0.5, 10.0), (0.0, 0.2, 2.0))
    for free, queued, gap, head, cap in grid:
        kw = dict(free=free, queued=queued, gap_s=gap, headroom_s=head,
                  max_hold_s=cap)
        assert admission_hold(**kw) == jax_planner.admission_hold(**kw)
    grid = itertools.product((0, 1, 4), (0, 1, 3), (-1.0, 0.0, 0.5, 30.0),
                             (0.0, 1.0), (None, 0.0, 0.04, 3.0))
    for waiting, host, head, cap, ema in grid:
        kw = dict(waiting=waiting, host_in_flight=host, headroom_s=head,
                  max_hold_s=cap, step_ema_s=ema)
        assert dispatch_hold(**kw) == jax_planner.dispatch_hold(**kw)


def test_planner_holds_and_edges_equal_jax_on_a_fake_clock():
    """One script of enqueues, admits and host steps through both
    planners (no journal): the same edges, holds and summary."""
    outs = []
    for mod, cfg_cls in ((None, ServeConfig),
                         (jax_planner, jax_server.ServeConfig)):
        from consensus_entropy_tpu_torch.serve.planner import (
            AdmissionPlanner,
        )

        cls = AdmissionPlanner if mod is None else mod.AdmissionPlanner
        router_cls = (BucketRouter if mod is None
                      else jax_buckets.BucketRouter)
        clock = _Clock()
        cfg = cfg_cls(planner_epoch=4, slo_interactive_s=5.0,
                      slo_batch_s=50.0, max_hold_s=1.0)
        router = router_cls()
        p = cls(cfg, router=router, clock=clock)
        log = []
        for i, pool in enumerate((12, 30, 60, 120, 31, 7, 90, 44)):
            clock.t = 0.5 * i
            p.observe_enqueue(pool, t=clock.t)
            log.append((p.edges, router.widths))
        p.note_admit("u0", "interactive", waited_s=1.0)
        clock.t = 5.0
        log.append(p.admission_hold_s(free=3, queued=1,
                                      head_waits={"batch": 2.0}))
        log.append(p.window_s(2, 1))
        p.note_host_step(0.2)
        log.append(p.window_s(2, 1))
        p.note_resolved("u0")
        log.append(p.headroom_s())
        log.append(p.summary())
        outs.append(log)
    assert outs[0] == outs[1]
    assert outs[0][3][0]  # edges derived at the fourth enqueue
