"""The operator plane against the JAX package's, on the CPU.

The status writer renames atomically, rate-limits and swallows failures;
torn and foreign files read as ``None``; ``HistoryRing`` deltas and
``validate_status`` verdicts equal JAX's, and both writers write the same
bytes for the same payload and clock (``tests/test_introspection.py:
51-116`` of the JAX package).  ``top.render`` gives JAX's string for the
same snapshots and ``now`` (``:483``).  ``amg_test --serve 2 --device cpu``
writes each user's results bit for bit alike with the plane on and with
``--no-introspection``, and status files only when it is on; an
``--alert-sink jsonl:`` run writes one parseable record per alert, and the
sink is refused with ``--no-introspection``, as in the JAX CLI."""

import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.cli import amg_test as jax_amg_test
from consensus_entropy_tpu.cli import top as jax_top
from consensus_entropy_tpu.obs import status as jax_status
from consensus_entropy_tpu_torch.cli import amg_test, top
from consensus_entropy_tpu_torch.cli import deam_classifier as port_deam
from consensus_entropy_tpu_torch.obs import status
from consensus_entropy_tpu_torch.obs.status import (
    HistoryRing,
    StatusWriter,
    read_status,
    read_status_dir,
    status_path,
    validate_status,
)
from tests.synth_data import build_synth_roots

torch.set_num_threads(1)


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def test_status_writer_atomic_rename_and_rate_limit(tmp_path):
    clock = _Clock()
    w = StatusWriter(str(tmp_path), "h0", interval_s=1.0, clock=clock)
    built = []

    def build():
        built.append(1)
        return {"live": 2, "queued": {"batch": 1}}

    assert w.maybe_write(build) is True
    snap = read_status(status_path(str(tmp_path), "h0"))
    assert snap["host"] == "h0" and snap["live"] == 2
    assert snap["t"] == 100.0 and snap["kind"] == "status"
    assert validate_status(snap) == []
    assert w.maybe_write(build) is False  # inside the interval: no build
    assert len(built) == 1
    clock.t += 1.5
    assert w.maybe_write(build) is True and len(built) == 2
    assert not os.path.exists(status_path(str(tmp_path), "h0") + ".tmp")
    # the JAX writer writes the same bytes for the same payload and clock
    theirs = jax_status.StatusWriter(str(tmp_path / "jax"), "h0",
                                     interval_s=1.0, clock=clock)
    theirs.write({"live": 2, "queued": {"batch": 1}})
    with open(status_path(str(tmp_path), "h0"), "rb") as a, \
            open(status_path(str(tmp_path / "jax"), "h0"), "rb") as b:
        assert a.read() == b.read()


def test_status_maybe_write_is_best_effort(tmp_path):
    clock = _Clock()
    w = StatusWriter(str(tmp_path), "h0", interval_s=1.0, clock=clock)

    def boom():
        raise OSError("disk full")

    assert w.maybe_write(boom) is False
    assert w.errors == 1 and w.writes == 0
    assert w.maybe_write(boom) is False  # inside the backoff interval
    assert w.errors == 1
    clock.t += 1.5
    assert w.maybe_write(lambda: {"live": 1}) is True and w.writes == 1
    with pytest.raises(TypeError):
        w.write(object())
    with pytest.raises(ValueError):
        StatusWriter(str(tmp_path), "h0", interval_s=-1)


BAD_SNAPSHOTS = [
    {"kind": "status", "host": "h0"},
    {"schema": 1, "kind": "status", "host": "h0", "t": "late"},
    {"schema": 1, "kind": "status", "host": "h0", "t": 1.0,
     "alerts": [{"no_kind": 1}]},
    {"schema": 1, "kind": "event", "host": "h0", "t": 1.0},
    {"schema": True, "kind": "status", "host": "h0", "t": 1.0},
]


def test_status_reader_tolerates_torn_and_foreign_files(tmp_path):
    StatusWriter(str(tmp_path), "h0", clock=_Clock()).write({"live": 1})
    (tmp_path / "status_h1.json").write_text('{"kind": "status", "ho')
    (tmp_path / "status_h2.json").write_text("[1, 2, 3]")
    (tmp_path / "status_h3.json").write_bytes(b"\xff\xfe")
    for h in ("h1", "h2", "h3", "h4"):
        assert read_status(str(tmp_path / f"status_{h}.json")) is None
    assert list(read_status_dir(str(tmp_path))) == ["h0"]
    assert read_status_dir(str(tmp_path)) == jax_status.read_status_dir(
        str(tmp_path))
    for snap in BAD_SNAPSHOTS:
        assert validate_status(snap)
        assert validate_status(snap) == jax_status.validate_status(snap)


def test_history_ring_deltas_equal_jax():
    rings = (HistoryRing(depth=3), jax_status.HistoryRing(depth=3))
    with pytest.raises(ValueError):
        HistoryRing(depth=1)
    frames = [{"h0": {"t": 1.0, "queue_total": 5, "users_done": 0}},
              {"h0": {"t": 1.0, "queue_total": 9, "users_done": 0}},
              {"h0": {"t": 2.5, "queue_total": 3, "users_done": 2},
               "c": {"t": 2.5, "unresolved": 4}},
              {"h0": {"t": 4.0, "queue_total": 1, "users_done": 3,
                      "live": True}},
              {"h0": {"t": 6.0, "queue_total": 0, "users_done": 5},
               "c": {"t": 3.0, "unresolved": 1}}]
    for f in frames:
        for ring in rings:
            ring.push(f)
    port, theirs = rings
    assert [s["t"] for s in port.history("h0")] == [2.5, 4.0, 6.0]
    for host in ("h0", "c", "nowhere"):
        assert port.history(host) == theirs.history(host)
        got = port.deltas(host, jax_top.DELTA_FIELDS)
        assert got == theirs.deltas(host, jax_top.DELTA_FIELDS)
    assert port.deltas("h0", ("queue_total", "users_done")) == {
        "queue_total": -3, "users_done": 3, "span_s": 3.5}


def _fleet_snapshots(root, clock):
    """A coordinator and two workers' snapshots (one stale, one with a
    delta history), written by the port's writer."""
    StatusWriter(str(root), "coordinator", clock=clock).write({
        "hosts": {"h0": {"alive": True, "joined": True, "draining": False,
                         "lease_age_s": 0.4, "load": 3},
                  "h1": {"alive": False, "joined": True, "draining": True,
                         "lease_age_s": None, "load": 1}},
        "unresolved": 4, "queued": 2, "in_flight": 2, "spawns": 2,
        "joins": 2, "migrations": 1, "fences": 1, "drains": 1,
        "draining_host": "h1", "edges": [64, 128], "hold_active": True,
        "holds": 2, "parked": 1, "disconnects": 1, "reconnects": 0,
        "alerts": [{"kind": "lease_expiry", "key": "h1", "host": "h1",
                    "age_s": 4.2, "lease_s": 5.0}]})
    StatusWriter(str(root), "h0", clock=clock).write({
        "queued": {"interactive": 1, "batch": 1}, "queue_total": 2,
        "live": 2, "target_live": 2, "draining": True, "intake_open": False,
        "fences_pending": 1, "users_done": 3, "users_failed": 0,
        "planner": {"edges": [64, 128], "observations": 12,
                    "admission_hold_rounds": 1, "dispatch_hold_rounds": 2},
        "buckets": {"128": {"occupancy": 0.5, "mean_batch": 1.0,
                            "dispatches": 2},
                    "64": {"occupancy": 1.0, "mean_batch": 2.0,
                           "dispatches": 7}},
        "breaker": {"64": "open"},
        "alerts": [{"kind": "slo_headroom", "key": "batch",
                    "cls": "batch", "p95_s": 9.5, "slo_s": 10.0}]})
    StatusWriter(str(root), "h1", interval_s=0.5,
                 clock=_Clock(clock.t - 30)).write({
                     "queued": {}, "queue_total": 0, "live": 0,
                     "target_live": 2, "users_done": 1, "users_failed": 1})


@pytest.mark.parametrize("now", [200.5, 203.2, 300.0])
def test_top_render_equals_jax(tmp_path, capsys, now):
    clock = _Clock(200.0)
    _fleet_snapshots(tmp_path / "status", clock)
    snaps = read_status_dir(str(tmp_path / "status"))
    frame = top.render(snaps, now=now)
    assert frame == jax_top.render(snaps, now=now)
    assert "[coordinator] fleet" in frame and "[h1]" in frame
    lines = frame.splitlines()
    # h1 wrote 30 s earlier; the others go stale after 3 of their 1 s
    # intervals
    assert "STALE" in next(ln for ln in lines if "[h1]" in ln)
    assert ("STALE" in lines[0]) == (now > 203.0)
    # the watch loop's delta lines, through each package's ring
    rings = (HistoryRing(), jax_status.HistoryRing())
    later = json.loads(json.dumps(snaps))
    later["h0"].update(t=205.0, queue_total=0, users_done=5)
    for ring in rings:
        ring.push(snaps)
        ring.push(later)
    frame = top.render(later, now=now, ring=rings[0])
    assert "Δ5s" in frame
    assert frame == jax_top.render(later, now=now, ring=rings[1])
    assert top.render({}, now=now) == jax_top.render({}, now=now)
    # --once resolves users/ to users/status/
    assert top.main([str(tmp_path), "--once", "--stale-s", "5"]) == 0
    assert "[coordinator] fleet" in capsys.readouterr().out


# -- the CLI ---------------------------------------------------------------

AL = ["-q", "3", "-e", "2", "-n", "10", "--max-users", "3", "-m", "mc"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Synthetic DEAM + AMG trees and a port registry (2 GaussianNB and 2
    SGD folds from the port's pre-training CLI)."""
    root = tmp_path_factory.mktemp("status")
    roots = build_synth_roots(root, np.random.default_rng(1987))
    flags = ["--models-root", roots["models"], "--deam-root", roots["deam"],
             "--amg-root", roots["amg"], "--device", "cpu"]
    for model in ("gnb", "sgd"):
        assert port_deam.main(["-cv", "2", "-m", model] + flags) == 0
    return roots


def _fresh(roots, dst):
    shutil.copytree(os.path.join(roots["models"], "pretrained"),
                    os.path.join(dst, "pretrained"))
    return str(dst)


def _results(models):
    """Each user's workspace files (metrics, state, members) as bytes."""
    users = os.path.join(models, "users")
    out = {}
    for u in sorted(os.listdir(users)):
        ws = os.path.join(users, u, "mc")
        if os.path.isdir(ws):
            for f in sorted(os.listdir(ws)):
                if f.endswith((".jsonl", ".json", ".npz")) \
                        and f != "timings.jsonl":
                    with open(os.path.join(ws, f), "rb") as fh:
                        out[(u, f)] = fh.read()
    return out


def _flags(roots, models, *extra):
    return AL + ["--serve", "2", *extra, "--models-root", models,
                 "--amg-root", roots["amg"], "--device", "cpu"]


def test_serve_results_are_the_same_bits_with_the_plane_off(trees,
                                                            tmp_path,
                                                            monkeypatch):
    # every serve round writes a snapshot, so the plane does the most
    # work it can beside the engine
    monkeypatch.setattr(status, "StatusWriter",
                        functools.partial(StatusWriter, interval_s=0.0))
    on = _fresh(trees, tmp_path / "on")
    off = _fresh(trees, tmp_path / "off")
    assert amg_test.main(_flags(trees, on)) == 0
    assert amg_test.main(_flags(trees, off, "--no-introspection")) == 0
    ours, bare = _results(on), _results(off)
    assert len({u for u, _ in ours}) == 3 and ours == bare
    snaps = read_status_dir(os.path.join(on, "users", "status"))
    assert list(snaps) == ["local"]
    assert validate_status(snaps["local"]) == []
    assert snaps["local"]["users_done"] == 3
    assert snaps["local"]["alert_sink_errors"] == 0
    assert not os.path.exists(os.path.join(off, "users", "status"))


def test_alert_sink_jsonl_records_every_alert(trees, tmp_path, monkeypatch):
    """A batch SLO far below any user's run time raises ``slo_headroom``
    once the first user finishes; the jsonl sink gets one parseable
    record per rise, the snapshot counts no sink failure, and the alert
    events in the metrics stream name the same alerts."""
    from consensus_entropy_tpu_torch.obs import export

    monkeypatch.setattr(status, "StatusWriter",
                        functools.partial(StatusWriter, interval_s=0.0))
    models = _fresh(trees, tmp_path / "m")
    sink = str(tmp_path / "alerts.jsonl")
    assert amg_test.main(_flags(trees, models, "--slo-batch-s", "0.001",
                                "--alert-sink", f"jsonl:{sink}")) == 0
    with open(sink) as f:
        recs = [json.loads(line) for line in f]
    assert recs and {r["kind"] for r in recs} == {"slo_headroom"}
    users = os.path.join(models, "users")
    (snap,) = read_status_dir(os.path.join(users, "status")).values()
    assert snap["alert_sink_errors"] == 0
    events = [e for e in export.read_jsonl_tolerant(
        os.path.join(users, "fleet_metrics.jsonl"))
        if e.get("event") == "alert"]
    assert [{k: v for k, v in e.items() if k in r and k != "key"}
            for e, r in zip(events, recs)] == [
        {k: v for k, v in r.items() if k != "key"} for r in recs]
    assert len(events) == len(recs)


@pytest.mark.parametrize("extra", [
    ["--alert-sink", "console", "--no-introspection"],
    ["--alert-sink", "nope"],
    ["--alert-sink", "jsonl"],
    ["--alert-sink", "cmd:"],
], ids=["no-introspection", "unknown", "jsonl-no-path", "cmd-no-command"])
def test_alert_sink_refusals_are_the_jax_clis(trees, tmp_path, capsys,
                                              extra):
    base = AL + ["--serve", "1", "--hosts", "2", *extra,
                 "--models-root", str(tmp_path)]
    assert jax_amg_test.main(base) == 1
    theirs = capsys.readouterr().out
    assert amg_test.main(base + ["--device", "cpu"]) == 1
    assert capsys.readouterr().out == theirs
    assert "--alert-sink" in theirs
    assert not os.listdir(tmp_path)  # refused before any work
