"""The readers of the program's spans: hand-computed values on a hand-made
traced run, nothing where the program wrote no such span, and the traced
CPU rehearsal of a cell reading the span metrics but no device one."""

import time
import types

import pytest

from benchmark import run, span_report, spans, spec
from benchmark.tests.conftest import add_cell
from benchmark.trace import Kernel, TraceData

NEW = ("device_idle.retrain_launch_ms", "device_idle.host_wait_ms",
       "retrain.read_ms", "retrain.cpu_share", "host_members.update_ms")


def _span(name, t0, t1, span=None, parent=None, **attrs):
    return {"name": name, "t0": t0, "dur_s": t1 - t0, "span": span,
            "parent": parent, **attrs}


def _ctx(with_spans=True, kernels=True):
    """A window of 10 s, two iterations.  The card is busy over [0, 1],
    [2, 3], [5, 6] and [9, 10]: idle over (1, 2), (3, 5), (6, 9).  Fit a
    covers [0.5, 4.5] with its read [4, 4.5], fit b [5.5, 8] with its read
    [7.5, 8]; fit c and its read lie before the window."""
    busy = [(0.0, 1.0), (2.0, 3.0), (5.0, 6.0), (9.0, 10.0)]
    trace = TraceData(0.0, 10.0, [Kernel("k", a, b, a, False)
                                  for a, b in busy]) if kernels else None
    recs = [
        _span("retrain", 0.4, 8.1, "d", "run", fn="cnn_retrain", batch=2),
        _span("retrain.fit", 0.5, 4.5, "a", "d", cpu_s=3.0),
        _span("retrain.read", 4.0, 4.5, "ra", "a", cpu_s=0.1),
        _span("retrain.fit", 5.5, 8.0, "b", "d", cpu_s=1.0),
        _span("retrain.read", 7.5, 8.0, "rb", "b", cpu_s=0.2),
        _span("retrain.fit", -3.0, -1.0, "c", "d", cpu_s=1.9),
        _span("retrain.read", -1.5, -1.0, "rc", "c", cpu_s=0.4),
        _span("host_wait", 1.5, 1.8, "w1", "run"),
        _span("host_wait", 8.5, 9.5, "w2", "run"),
        _span("member.update", -1.0, 0.5, "u1", "h", kind="xgb", cpu_s=1),
        _span("member.update", 9.5, 11.0, "u2", "h", kind="gnb", cpu_s=1),
        _span("member.update", 2.0, 3.0, "u3", "h", kind="sgd", cpu_s=1),
    ]
    return types.SimpleNamespace(window=(0.0, 10.0), iterations=2.0,
                                 trace=trace,
                                 spans=recs if with_spans else [])


def _read(name, ctx):
    return spec.reader(name)(ctx)


def test_interval_helpers():
    assert spans.subtract([(0, 10)], [(2, 3), (5, 12)]) == [(0, 2), (3, 5)]
    assert spans.subtract([(0, 1), (4, 6)], [(1, 4)]) == [(0, 1), (4, 6)]
    assert spans.subtract([(0, 4)], [(0, 4)]) == []
    assert spans.overlap([(0, 2), (5, 9)], [(1, 6), (8, 20)]) == \
        pytest.approx(1 + 1 + 1)
    assert spans.overlap([(0, 1)], []) == 0.0


def test_each_reader_gives_the_hand_computed_value():
    ctx = _ctx()
    # idle inside the fits less their reads: (1, 2) and (3, 4) under a,
    # (6, 7.5) under b; 3.5 s over two iterations
    assert _read(NEW[0], ctx) == pytest.approx(1750.0)
    # idle under the waits: (1.5, 1.8) and (8.5, 9)
    assert _read(NEW[1], ctx) == pytest.approx(400.0)
    # the reads inside the window: a's and b's, 0.5 s each
    assert _read(NEW[2], ctx) == pytest.approx(500.0)
    # fits a and b start in the window: (3.0 - 0.1 + 1.0 - 0.2) s of CPU
    # over (4 - 0.5 + 2.5 - 0.5) s of wall
    assert _read(NEW[3], ctx) == pytest.approx(100.0 * 3.7 / 5.5)
    # the updates clipped to the window: 0.5 + 0.5 + 1 s
    assert _read(NEW[4], ctx) == pytest.approx(1000.0)


def test_span_report_splits_the_idle_card_by_hand():
    ctx = _ctx()
    ctx.report = types.SimpleNamespace(
        host_steps=[("update_host", 3_000_000_000, 6_000_000_000)])
    ctx.config = {"retrain_epochs": 2}
    out = span_report.analyze(ctx)
    # idle (1, 2), (3, 5), (6, 9): the launches take (1, 2), (3, 4) and
    # (6, 7.5); the reads (4, 4.5) and (7.5, 8); the dispatch outside its
    # fits (4.5, 5) and (8, 8.1); the second wait (8.5, 9); (8.1, 8.5)
    # is left
    assert out["idle_split_ms"] == pytest.approx({
        "idle": 3000.0, "retrain_launch": 1750.0, "retrain_read": 500.0,
        "retrain_outside_fits": 300.0, "host_wait": 250.0,
        "score_dispatch": 0.0, "rest": 200.0})
    # launched at 2 and 5 inside the dispatch, 2 inside fit a
    assert out["alignment"] == {"kernels_launched_in_retrain": 2,
                                "of_them_in_a_fit": 1, "share": 0.5}
    # the kernel launched at 2, over 5.5 s of launch stretches in the
    # window, busy over 2 s of them; fits a and b of two epochs each; the
    # host step covers (3, 4) and (5.5, 6) of the 7 s of stretches
    assert out["launches"] == pytest.approx({
        "kernels": 1, "host_us_each": 5.5e6, "device_us_each": 1e6,
        "per_member_epoch": 0.25, "busy_share": 2 / 5.5,
        "under_host_steps": 1.5 / 7})
    assert out["sums_ms"] == pytest.approx(
        {"retrain": 3850.0, "read": 500.0, "fit_less_read": 2750.0})
    assert out["updates"] == {
        "gnb": {"ms": pytest.approx(250.0), "cpu_share": 1 / 1.5, "n": 1},
        "sgd": {"ms": pytest.approx(500.0), "cpu_share": 1.0, "n": 1},
        "xgb": {"ms": pytest.approx(250.0), "cpu_share": None, "n": 0}}


def test_readers_find_nothing_without_the_spans_or_the_card():
    for name in NEW:
        assert _read(name, _ctx(with_spans=False)) is None
    ctx = _ctx(kernels=False)
    assert _read(NEW[0], ctx) is None and _read(NEW[1], ctx) is None
    assert _read(NEW[2], ctx) == pytest.approx(500.0)


def test_traced_run_on_the_cpu_reads_the_span_metrics(tmp_path):
    bench, here = add_cell(tmp_path)
    cell = spec.resolve(bench, "tiny.cohort2-mc", root=tmp_path, here=here)
    assert set(NEW) <= {m["name"] for m in cell.per_layer}
    line = run.run_cell(cell, 2 ** 31 + 11, 2.0, True, "cpu",
                        t_start=time.time(), log=lambda m: None)
    assert line["correct"], line["checks"]
    for name in ("retrain.cpu_share", "host_members.update_ms"):
        assert line["metrics"][name]["value"] > 0, name
    # a read on the CPU lasts microseconds; on a busy host no fit of the
    # short window may end inside it
    assert line["metrics"]["retrain.read_ms"]["value"] >= 0
    assert 0 < line["metrics"]["retrain.cpu_share"]["value"] <= 100.5
    for name in ("device_idle.retrain_launch_ms",
                 "device_idle.host_wait_ms"):
        assert name not in line["metrics"]
