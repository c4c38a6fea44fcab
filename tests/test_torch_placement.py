"""The fabric's pure decision kernels against the JAX package's, on the CPU.

``serve.placement`` (bucket, view, place, failover and rebalance plans),
``serve.remedy`` (shed counts, hysteresis, fence deadlines, the gray ladder
and depth dial, victim picks), ``serve.elastic`` (host ids, the
autoscaler's and the low-water kernels, the drain victim) and
``obs.alerts`` (every alert kernel, the watcher's edge trigger and rearm,
the sinks) take the same seeded and hypothesis-drawn inputs in both
packages; every output is equal (tolerance 0: the same integer and float
arithmetic).  ``QuantileSketch.merge_all`` equals the JAX fold, and the
fleet planner derives, journals and restores the same edges from the
same per-host sketches."""

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from consensus_entropy_tpu.obs import alerts as jax_alerts
from consensus_entropy_tpu.obs.metrics import QuantileSketch as JaxSketch
from consensus_entropy_tpu.serve import elastic as jax_elastic
from consensus_entropy_tpu.serve import placement as jax_placement
from consensus_entropy_tpu.serve import remedy as jax_remedy
from consensus_entropy_tpu.serve.journal import (
    AdmissionJournal as JaxJournal,
)
from consensus_entropy_tpu_torch.obs import alerts
from consensus_entropy_tpu_torch.obs.metrics import QuantileSketch
from consensus_entropy_tpu_torch.serve import (
    AdmissionJournal,
    elastic,
    placement,
    remedy,
    validate_journal_file,
)

torch.set_num_threads(1)

HOSTS = st.lists(st.sampled_from([f"h{i}" for i in range(6)] + ["vol"]),
                 min_size=1, max_size=5, unique=True)
POOLS = st.one_of(st.none(), st.integers(1, 700))
EDGES = st.sampled_from([(), (120, 480), (64, 256, 512), (33,)])
TIMES = st.one_of(st.none(), st.floats(0, 100, allow_nan=False))


def _both(name_port, name_jax, *args, **kw):
    """Call both packages' function; equal results, or equal errors."""
    try:
        ours = name_port(*args, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as theirs:
            name_jax(*args, **kw)
        assert str(e) == str(theirs.value)
        return None
    assert ours == name_jax(*args, **kw)
    return ours


# -- placement -------------------------------------------------------------


@settings(max_examples=60, deadline=None, database=None)
@given(POOLS, EDGES)
def test_bucket_for_matches(pool, edges):
    _both(placement.bucket_for, jax_placement.bucket_for, pool, edges)


@settings(max_examples=60, deadline=None, database=None)
@given(st.data(), HOSTS, st.sampled_from(["bucket", "load", "x"]),
       st.integers(1, 6), st.booleans())
def test_place_matches(data, hosts, policy, skew, with_devices):
    loads = {h: data.draw(st.integers(0, 12)) for h in hosts}
    buckets = {h: {b: data.draw(st.integers(0, 4))
                   for b in data.draw(st.lists(
                       st.sampled_from([32, 64, 128, 512]), max_size=3))}
               for h in hosts}
    devices = ({h: data.draw(st.sampled_from([1, 2, 4])) for h in hosts}
               if with_devices else None)
    bucket = data.draw(st.one_of(st.none(),
                                 st.sampled_from([32, 64, 128, 512])))
    _both(placement.place, jax_placement.place, bucket, loads=loads,
          buckets_by_host=buckets, policy=policy, max_skew=skew,
          devices=devices)


def test_place_refuses_an_empty_fleet():
    _both(placement.place, jax_placement.place, 32, loads={},
          buckets_by_host={})


def _journals(tmp_path, records):
    """The same records written through each package's journal; returns
    the two replayed states."""
    out = []
    for pkg, cls in (("port", AdmissionJournal), ("jax", JaxJournal)):
        path = str(tmp_path / f"{pkg}.jsonl")
        with cls(path) as j:
            for event, user, fields in records:
                j.append(event, user, **fields)
        out.append(cls(path).state)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_place_user_and_plans_match_on_seeded_journals(tmp_path, seed):
    rng = np.random.default_rng(seed)
    users = [f"u{i}" for i in range(int(rng.integers(3, 12)))]
    hosts = [f"h{i}" for i in range(int(rng.integers(1, 4)))]
    records = []
    for u in users:
        fields = {}
        if rng.random() < 0.8:
            fields["pool"] = int(rng.choice([20, 30, 100, 300, 600]))
        records.append(("enqueue", u, fields))
        if rng.random() < 0.7:
            records.append(("assign", u,
                            {"host": str(rng.choice(hosts + ["h9"]))}))
    st_port, st_jax = _journals(tmp_path, records)
    unresolved = {u for u in users if rng.random() < 0.8}
    edges = ((), (64, 512))[seed % 2]
    devices = {h: int(rng.choice([1, 2, 4])) for h in hosts} \
        if seed % 3 == 0 else None
    for policy in ("bucket", "load"):
        kw = dict(unresolved=unresolved, hosts=hosts, edges=edges,
                  policy=policy, devices=devices)
        assert placement.placement_view(st_port, unresolved, hosts,
                                        edges) == \
            jax_placement.placement_view(st_jax, unresolved, hosts, edges)
        for u in sorted(unresolved):
            assert placement.place_user(u, state=st_port, **kw) == \
                jax_placement.place_user(u, state=st_jax, **kw)
        victims = sorted(unresolved)[::-1]
        assert placement.plan_failover(victims, state=st_port, **kw) == \
            jax_placement.plan_failover(victims, state=st_jax, **kw)


@settings(max_examples=60, deadline=None, database=None)
@given(st.data(), HOSTS)
def test_plan_rebalance_matches(data, hosts):
    new = hosts[0]
    loads = {h: data.draw(st.integers(0, 9)) for h in hosts}
    loads[new] = data.draw(st.integers(0, 2))
    queued = {h: [f"{h}u{i}" for i in range(data.draw(st.integers(0, 6)))]
              for h in hosts[1:]}
    _both(placement.plan_rebalance, jax_placement.plan_rebalance, new,
          loads=loads, queued_by_host=queued)


# -- remedy ----------------------------------------------------------------


@settings(max_examples=80, deadline=None, database=None)
@given(st.integers(0, 30), st.integers(0, 30), st.integers(1, 8), TIMES,
       st.floats(0, 100, allow_nan=False), st.floats(0, 20,
                                                     allow_nan=False))
def test_remedy_kernels_match(load, floor, skew, since, now, hold):
    assert remedy.shed_count(load, floor, max_skew=skew) == \
        jax_remedy.shed_count(load, floor, max_skew=skew)
    for ours, theirs, kw in (
            (remedy.remedy_due, jax_remedy.remedy_due, {"hold_s": hold}),
            (remedy.cooldown_ok, jax_remedy.cooldown_ok,
             {"cooldown_s": hold}),
            (remedy.fence_expired, jax_remedy.fence_expired,
             {"deadline_s": hold}),
            (remedy.probation_clear, jax_remedy.probation_clear,
             {"clear_s": hold})):
        assert ours(since, now, **kw) == theirs(since, now, **kw)
    assert remedy.gray_rung(since, now, hold_s=hold, drain_s=hold / 2) == \
        jax_remedy.gray_rung(since, now, hold_s=hold, drain_s=hold / 2)
    for probation in (False, True):
        assert remedy.degrade_depth(probation, since, hold_s=hold) == \
            jax_remedy.degrade_depth(probation, since, hold_s=hold)


@settings(max_examples=60, deadline=None, database=None)
@given(st.integers(0, 6), st.integers(0, 6), st.integers(-1, 10),
       st.booleans())
def test_pick_shed_matches(n_queued, n_flight, count, migrate):
    queued = [f"q{i}" for i in range(n_queued)]
    flight = [f"f{i}" for i in range(n_flight)]
    assert remedy.pick_shed(queued, flight, count,
                            migrate_inflight=migrate) == \
        jax_remedy.pick_shed(queued, flight, count,
                             migrate_inflight=migrate)


def test_remedy_constants_match():
    for name in dir(jax_remedy):
        if name.startswith("DEFAULT_") or name == "GRAY_RUNGS":
            assert getattr(remedy, name) == getattr(jax_remedy, name), name


# -- elastic ---------------------------------------------------------------


@settings(max_examples=60, deadline=None, database=None)
@given(st.lists(st.sampled_from(["h0", "h1", "h3", "h10", "x", "h"]),
                max_size=5))
def test_next_host_id_matches(ids):
    assert elastic.next_host_id(ids) == jax_elastic.next_host_id(ids)


@settings(max_examples=100, deadline=None, database=None)
@given(st.integers(0, 6), st.integers(0, 40), st.integers(1, 3),
       st.integers(3, 6), st.integers(1, 8),
       st.sampled_from([0.0, 10.0, 60.0]),
       st.one_of(st.none(), st.floats(0.1, 9, allow_nan=False)))
def test_autoscaler_kernels_match(live, queued, lo, hi, backlog, slo,
                                  ema):
    kw = dict(queued=queued, min_hosts=lo, scale_backlog=backlog,
              scale_slo_s=slo, finish_ema_s=ema)
    assert elastic.target_hosts(live=live, max_hosts=hi, **kw) == \
        jax_elastic.target_hosts(live=live, max_hosts=hi, **kw)
    assert elastic.scale_down_ok(live=live, **kw) == \
        jax_elastic.scale_down_ok(live=live, **kw)


@settings(max_examples=60, deadline=None, database=None)
@given(st.dictionaries(st.sampled_from(["h0", "h1", "h2", "h10", "vol"]),
                       st.integers(0, 5), max_size=5))
def test_drain_victim_matches(loads):
    _both(elastic.drain_victim, jax_elastic.drain_victim, loads)


# -- sketches and the fleet planner ----------------------------------------


def _sketch_pair(values, **kw):
    ours, theirs = QuantileSketch(**kw), JaxSketch(**kw)
    for v in values:
        ours.add(v)
        theirs.add(v)
    return ours, theirs


@pytest.mark.parametrize("seed", range(4))
def test_sketch_merge_all_matches(seed):
    """The JAX cases (``tests/test_elastic.py:532-545``): chained merges
    equal the fold, and the fold equals JAX's, reservoir or not."""
    rng = np.random.default_rng(seed)
    max_samples = (8, 4096)[seed % 2]
    parts = [rng.integers(1, 900, int(rng.integers(0, 12))).tolist()
             for _ in range(int(rng.integers(1, 5)))]
    dicts = [_sketch_pair(p, max_samples=max_samples)[0].to_dict()
             for p in parts]
    ours = QuantileSketch.merge_all(dicts)
    assert ours.to_dict() == JaxSketch.merge_all(dicts).to_dict()
    chained = QuantileSketch.from_dict(dicts[0])
    for d in dicts[1:]:
        chained.merge(QuantileSketch.from_dict(d))
    assert chained.to_dict() == ours.to_dict()
    for q in (10, 50, 90, 99):
        assert ours.percentile(q) == \
            JaxSketch.merge_all(dicts).percentile(q)
    assert QuantileSketch.merge_all([]).to_dict() == \
        JaxSketch.merge_all([]).to_dict()


def test_fleet_planner_edges_match(tmp_path):
    """Per-host planner records in each package's journal: both fleet
    planners merge, derive and journal the same edges at the same epoch,
    and restore them after a restart."""
    from consensus_entropy_tpu.serve.elastic import FleetPlanner as JaxFP
    from consensus_entropy_tpu_torch.serve.elastic import FleetPlanner

    rng = np.random.default_rng(3)
    per_host = {h: rng.choice([30, 100, 300, 600], 6).tolist()
                for h in ("h0", "h1", "h2")}
    out = {}
    for pkg, journal_cls, fp_cls, sk in (
            ("port", AdmissionJournal, FleetPlanner, QuantileSketch),
            ("jax", JaxJournal, JaxFP, JaxSketch)):
        jp = str(tmp_path / f"{pkg}.jsonl")
        with journal_cls(jp) as j:
            fp = fp_cls(j, epoch=4, n_buckets=3)
            seen = []
            for h, pools in per_host.items():
                for i in range(0, len(pools), 3):
                    s = sk()
                    for v in pools[: i + 3]:
                        s.add(v)
                    fp.note_host_sketch(h, s.to_dict())
                    seen.append(fp.poll())
            out[pkg] = (seen, fp.edges, fp.merged().to_dict(),
                        fp.summary())
        with journal_cls(jp) as j2:
            restored = fp_cls(j2, epoch=4)
            out[pkg] += (restored.edges, restored.merged().n)
        assert validate_journal_file(jp) == []
    assert out["port"] == out["jax"]
    assert out["port"][1]


# -- alerts ----------------------------------------------------------------


@settings(max_examples=80, deadline=None, database=None)
@given(st.data())
def test_alert_kernels_match(data):
    classes = ["interactive", "batch"]
    p95 = {c: data.draw(st.floats(0, 100, allow_nan=False))
           for c in classes if data.draw(st.booleans())}
    slo = {c: data.draw(st.floats(1, 80, allow_nan=False)) for c in classes}
    frac = data.draw(st.floats(0.1, 1.0, allow_nan=False))
    assert alerts.slo_headroom_alerts(p95, slo, burn_frac=frac) == \
        jax_alerts.slo_headroom_alerts(p95, slo, burn_frac=frac)
    waits = {c: data.draw(st.one_of(st.none(),
                                    st.floats(0, 90, allow_nan=False)))
             for c in classes}
    aging = data.draw(st.sampled_from([0.0, 5.0, 30.0]))
    assert alerts.batch_aging_alerts(waits, aging) == \
        jax_alerts.batch_aging_alerts(waits, aging)
    states = {w: {"state": data.draw(st.sampled_from(
        ["closed", "open", "half_open", "spent"])), "failures": 2}
        for w in (32, 64, 128) if data.draw(st.booleans())}
    assert alerts.breaker_alerts(states) == \
        jax_alerts.breaker_alerts(states)
    assert alerts.breaker_alerts(None) == jax_alerts.breaker_alerts(None)
    hosts = ["h0", "h1", "h2", "h3"]
    ages = {h: data.draw(st.one_of(st.none(), st.floats(
        0, 12, allow_nan=False))) for h in hosts}
    assert alerts.lease_alerts(ages, 5.0, burn_frac=frac) == \
        jax_alerts.lease_alerts(ages, 5.0, burn_frac=frac)
    loads = {h: data.draw(st.integers(0, 12)) for h in hosts}
    skew = data.draw(st.integers(1, 5))
    assert alerts.skew_alerts(loads, max_skew=skew) == \
        jax_alerts.skew_alerts(loads, max_skew=skew)
    signals = {k: {h: data.draw(st.one_of(st.none(), st.floats(
        0, 30, allow_nan=False))) for h in hosts}
        for k in ("append_ages", "ack_lags", "lease_ages", "step_walls")}
    kw = dict(ratio=data.draw(st.floats(1, 5, allow_nan=False)),
              min_abs_s=data.draw(st.floats(0, 3, allow_nan=False)))
    assert alerts.gray_suspect_alerts(**signals, **kw) == \
        jax_alerts.gray_suspect_alerts(**signals, **kw)


class _Rec:
    def __init__(self):
        self.events = []

    def event(self, kind, /, **kw):
        self.events.append((kind, kw))


def test_alert_watcher_and_sinks_match(tmp_path):
    """The same evaluation rounds through both watchers: the same risen
    alerts, events, active sets and rearms; sinks write the same lines and
    ``make_sink`` refuses the same specs with the same words."""
    rounds = [
        alerts.slo_headroom_alerts({"batch": 700.0}, {"batch": 600.0}),
        alerts.slo_headroom_alerts({"batch": 700.0}, {"batch": 600.0})
        + alerts.skew_alerts({"h0": 9, "h1": 0}, max_skew=4),
        alerts.skew_alerts({"h0": 9, "h1": 0}, max_skew=4),
        [],
        alerts.skew_alerts({"h0": 9, "h1": 0}, max_skew=4),
    ]
    out = {}
    for pkg, mod in (("port", alerts), ("jax", jax_alerts)):
        rec, lines = _Rec(), []
        path = str(tmp_path / f"{pkg}.jsonl")
        sink = mod.make_sink(f"jsonl:{path}")
        w = mod.AlertWatcher(rec, log=lines.append,
                             sinks=(sink, mod.ConsoleSink(lines.append)))
        risen = []
        for i, r in enumerate(rounds):
            risen.append(w.update(r))
            if i == 2:
                w.rearm("placement_skew", "h0")
        sink.close()
        with open(path, "rb") as f:
            body = f.read()
        out[pkg] = (risen, rec.events, w.active, w.fired, lines, body)
    assert out["port"] == out["jax"]
    for spec in ("nope", "jsonl", "cmd:", "jsonl:"):
        with pytest.raises(ValueError) as ours:
            alerts.make_sink(spec)
        with pytest.raises(ValueError) as theirs:
            jax_alerts.make_sink(spec)
        assert str(ours.value) == str(theirs.value)
    assert alerts.ALERT_KINDS == jax_alerts.ALERT_KINDS
    assert (alerts.BURN_FRAC, alerts.GRAY_RATIO, alerts.GRAY_MIN_ABS_S) == (
        jax_alerts.BURN_FRAC, jax_alerts.GRAY_RATIO,
        jax_alerts.GRAY_MIN_ABS_S)
    assert os.path.exists(str(tmp_path / "port.jsonl"))
