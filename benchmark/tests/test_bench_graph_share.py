"""The reader of ``retrain.graph_share`` on hand-made ``retrain.fit`` spans:
the share of the fits starting in the window that replayed a graph, and
nothing where the program wrote no ``graphed`` attribute."""

import types

import pytest

from benchmark import spec


def _fit(span, t0, t1, **attrs):
    return {"name": "retrain.fit", "t0": t0, "dur_s": t1 - t0,
            "span": span, "parent": "d", **attrs}


def _ctx(fits):
    return types.SimpleNamespace(window=(0.0, 10.0), iterations=2.0,
                                 trace=None, spans=fits)


def _read(ctx):
    return spec.reader("retrain.graph_share")(ctx)


def test_graph_share_counts_the_fits_starting_in_the_window():
    # fits a and b start in the window, c before it
    spans = [_fit("a", 0.5, 4.5), _fit("b", 5.5, 8.0), _fit("c", -3.0, -1.0)]
    assert _read(_ctx(spans)) is None
    graphed = {"a": True, "b": False, "c": True}
    for s in spans:
        s.update(graphed=graphed[s["span"]], captured=s["span"] == "c")
    assert _read(_ctx(spans)) == pytest.approx(50.0)
    for s in spans:
        s["graphed"] = True
    assert _read(_ctx(spans)) == pytest.approx(100.0)
    # a fit that starts at the window's end is outside it
    spans.append(_fit("e", 10.0, 11.0, graphed=False))
    assert _read(_ctx(spans)) == pytest.approx(100.0)


def test_graph_share_reads_nothing_without_fits_in_the_window():
    assert _read(_ctx([])) is None
    other = {"name": "retrain", "t0": 1.0, "dur_s": 1.0, "span": "d",
             "parent": "run", "graphed": True}
    assert _read(_ctx([other])) is None
    assert _read(_ctx([_fit("c", -3.0, -1.0, graphed=True)])) is None
