"""The port's observability against the JAX package's, on the CPU.

``Histogram`` and ``QuantileSketch`` give the JAX package's percentiles,
snapshots, merges and dicts on the same seeded samples (tolerance 0: the
same float operations in the same order), inside and past the exact
reservoir; the span tracer derives the same trace and span ids for the
same calls; ``validate_metrics``, ``load_spans``, ``orphan_spans`` and
``chrome_trace`` return what the JAX package's return on the same
records; the null tracer records nothing; the device profiler's CPU
capture writes a Chrome trace."""

import json
import os

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.obs import export as jax_export
from consensus_entropy_tpu.obs import metrics as jax_metrics
from consensus_entropy_tpu.obs import trace as jax_trace
from consensus_entropy_tpu_torch.obs import export, metrics, trace

torch.set_num_threads(1)


def _samples(seed, n, scale=1.0):
    return (np.random.default_rng(seed).lognormal(0.0, 1.0, n)
            * scale).tolist()


@pytest.mark.parametrize("n, max_samples", [(1, 4096), (37, 4096),
                                            (500, 4096), (300, 128)])
def test_histogram_percentiles_and_snapshots_equal_jax(n, max_samples):
    xs = _samples(n, n) + [0.0, -1.5]  # the non-positive bucket too
    ours = metrics.Histogram(max_samples=max_samples)
    theirs = jax_metrics.Histogram(max_samples=max_samples)
    for x in xs:
        ours.add(x)
        theirs.add(x)
    for q in (0, 1, 5, 25, 50, 75, 90, 95, 99, 99.9, 100):
        assert ours.percentile(q) == theirs.percentile(q)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.exact == theirs.exact == (len(xs) <= max_samples)
    if ours.exact:  # numpy's linear percentile, bit for bit
        assert ours.percentile(95) == float(np.percentile(xs, 95))


def test_sketch_merge_and_dicts_equal_jax():
    parts = [_samples(10 + i, k, 100.0) for i, k in enumerate((40, 70, 3))]
    ours, theirs = [], []
    for xs in parts:
        a, b = metrics.QuantileSketch(), jax_metrics.QuantileSketch()
        for x in xs:
            a.add(x)
            b.add(x)
        assert a.to_dict() == b.to_dict()
        ours.append(a)
        theirs.append(b)
    merged = ours[0].merge(ours[1]).merge(ours[2])
    jax_merged = theirs[0].merge(theirs[1]).merge(theirs[2])
    assert merged.to_dict() == jax_merged.to_dict()
    d = json.loads(json.dumps(merged.to_dict()))  # the journal's trip
    back = metrics.QuantileSketch.from_dict(d)
    jax_back = jax_metrics.QuantileSketch.from_dict(d)
    assert back.to_dict() == jax_back.to_dict() == merged.to_dict()
    for q in (10, 50, 95):
        assert back.percentile(q) == jax_back.percentile(q)
    # past the reservoir the sketch keeps buckets only, in both packages
    small = [metrics.QuantileSketch(max_samples=50),
             jax_metrics.QuantileSketch(max_samples=50)]
    for sk in small:
        for x in _samples(3, 80, 10.0):
            sk.add(x)
    assert small[0].to_dict() == small[1].to_dict()
    assert small[0].percentile(90) == small[1].percentile(90)
    with pytest.raises(ValueError, match="geometry"):
        metrics.QuantileSketch().merge(small[0])
    assert metrics.ema(None, 2.0) == jax_metrics.ema(None, 2.0)
    assert metrics.ema(1.0, 2.0) == jax_metrics.ema(1.0, 2.0)


def test_registry_kinds_and_snapshot():
    reg = metrics.MetricsRegistry()
    reg.counter("c").inc(3)
    reg.gauge("g").set(1.5)
    reg.histogram("h").add(2.0)
    reg.rolling("r").add(4.0)
    snap = reg.snapshot()
    assert snap["c"] == 3 and snap["g"] == 1.5
    assert snap["h"]["p50"] == 2.0 and snap["r"]["mean"] == 4.0
    with pytest.raises(TypeError, match="Counter"):
        reg.gauge("c")


def _drive(mod, t0=1000.0):
    """The same calls on a tracer of either package; returns the tracer
    (its in-memory records) with wall stamps replaced below."""
    tr = mod.Tracer(None, run_id="mc-7", host="h0")
    tr.open_user("u1", t0=t0)
    uctx = tr.user_ctx("u1")
    it = tr.begin("al_iter", parent=uctx, key=("u1", 0), user="u1",
                  epoch=0)
    with tr.span("host_step", parent=it, key=("u1", 0, "select"),
                 user="u1", label="select"):
        pass
    tr.end(it, queried=4)
    tr.span_at("admission_wait", t0, t0 + 0.5, parent=uctx,
               key=("u1", 1), user="u1", width=32)
    tr.control_event("ctl.compact", key=(12, 1), compactions=1)
    tr.control_event("ctl.breaker", key=(13, "32", "open"), width="32",
                     state="open", prev="closed", flow_user="u1")
    tr.close_user("u1", resumes=0)
    tr.close()
    return tr


def _ids(records):
    return [(r["name"], r["trace"], r["span"], r["parent"])
            for r in records]


def test_span_and_trace_ids_equal_jax():
    ours, theirs = _drive(trace), _drive(jax_trace)
    assert _ids(ours.records) == _ids(theirs.records)
    assert trace.trace_id("r") == jax_trace.trace_id("r")
    assert trace.trace_id("r", 5) == jax_trace.trace_id("r", 5)
    names = [r["name"] for r in ours.records]
    assert names == ["host_step", "al_iter", "admission_wait",
                     "ctl.compact", "ctl.breaker", "user", "run"]
    merged = export.load_spans([])  # no files: nothing
    assert merged == []
    assert export.orphan_spans(ours.records) == []


def _stamped(records):
    """The records with their wall stamps fixed (the two packages ran at
    different instants), so exports compare whole."""
    out = []
    for i, r in enumerate(records):
        r = dict(r)
        r["t0"] = 1000.0 + i
        r["dur_s"] = 0.25 * (i % 3)
        out.append(r)
    return out


def test_chrome_trace_and_span_merge_equal_jax(tmp_path):
    recs = _stamped(_drive(jax_trace).records)
    assert export.chrome_trace(recs) == jax_export.chrome_trace(recs)
    # a resumed attempt rewrites a span id with a longer duration, a torn
    # tail ends the file: both readers keep the same merged set
    path = tmp_path / "spans.jsonl"
    longer = dict(recs[1], dur_s=9.0)
    with open(path, "w") as f:
        for r in recs + [longer]:
            f.write(json.dumps(r) + "\n")
        f.write('{"ev": "span", "trace"')
    ours = export.load_spans([str(path)])
    assert ours == jax_export.load_spans([str(path)])
    assert len(ours) == len(recs)
    assert [r for r in ours if r["span"] == recs[1]["span"]][0][
        "dur_s"] == 9.0
    orphan = dict(recs[0], span="x", parent="missing")
    assert export.orphan_spans(ours + [orphan]) == [orphan]


def test_validate_metrics_equals_jax(tmp_path):
    good = [{"schema": 2, "event": "enqueue", "t_s": 0.1, "user": "u0",
             "depth": 1, "cls": "batch"},
            {"schema": 2, "event": "admit", "t_s": 0.2, "user": "u0",
             "width": 32, "wait_s": 0.1, "depth": 0, "live": 1},
            {"schema": 2, "event": "fleet_summary", "users_done": 1}]
    bad = good + [{"schema": 1, "event": "enqueue"},
                  {"schema": 2, "event": "nope", "t_s": 1},
                  {"schema": 2, "event": "admit", "user": "u1",
                   "width": "32", "wait_s": True, "depth": 0},
                  {"schema": 2, "event": "breaker_open", "width": 8}]
    assert export.validate_metrics(good) == []
    errs = export.validate_metrics(bad, path="m.jsonl")
    assert errs == jax_export.validate_metrics(bad, path="m.jsonl")
    assert len(errs) == 7
    assert export.EVENT_FIELDS == jax_export.EVENT_FIELDS
    path = tmp_path / "fleet_metrics.jsonl"
    with open(path, "w") as f:
        for r in good:
            f.write(json.dumps(r) + "\n")
        f.write('{"schema": 2, "ev')  # torn tail: skipped
    assert export.read_jsonl_tolerant(str(path)) == good
    assert export.validate_metrics_file(str(path)) == []
    assert export.merged_summary(str(tmp_path)) == \
        jax_export.merged_summary(str(tmp_path))
    assert export.text_report(str(tmp_path)) == \
        jax_export.text_report(str(tmp_path))
    assert export.alert_counts(str(tmp_path)) == {}


def test_null_tracer_is_inert(tmp_path):
    null = trace.NULL_TRACER
    assert not null.enabled
    assert null.begin("al_iter") is None and null.user_ctx("u") is None
    with null.span("x") as ctx:
        assert ctx is None
    null.span_at("x", 0.0, 1.0)
    null.open_user("u")
    null.control_event("ctl.x", key=1)
    null.close_user("u")
    assert null.records == [] and null.user_open_t0("u") is None
    off = trace.Tracer(str(tmp_path / "spans.jsonl"), enabled=False)
    off.open_user("u")
    off.close()
    assert not os.path.exists(tmp_path / "spans.jsonl")


def test_device_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    with trace.device_trace(str(tmp_path / "prof"), "cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name")) for e in events)
    with trace.device_trace(None):  # no directory: no capture
        pass
