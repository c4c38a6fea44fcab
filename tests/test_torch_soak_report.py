"""The ``soak`` and ``report`` CLIs against the JAX package's, on the CPU.

``soak gen`` writes the JAX ``gen``'s bytes and prints its line for the
same arguments (poisson, mmpp with churn and a horizon, replay, skewed
pools), ``digest`` prints the same summary of either package's file, and
``grade`` prints the same JSON and exit code on the same run (a port
``amg_test --serve 2`` directory, with and without a trace and SLOs); bad
arguments fail with the same words.  ``report`` over the same users
directory (``tests/test_obs.py:481-500`` of the JAX package) prints the
same text, validates alike, and writes the same Chrome trace; a broken
metrics line makes both exit 1.  Tolerance: none, every comparison is
exact."""

import json
import os

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.cli import report as jax_report
from consensus_entropy_tpu.cli import soak as jax_soak
from consensus_entropy_tpu_torch.cli import amg_test, report, soak
from consensus_entropy_tpu_torch.cli import deam_classifier as port_deam
from tests.synth_data import build_synth_roots

torch.set_num_threads(1)

GEN_ARGS = [
    ["--seed", "3", "--users", "8"],
    ["--seed", "4", "--users", "12", "--arrival", "mmpp", "--rate", "2",
     "--burst-dwell-s", "0.5", "--churn-frac", "0.25", "--horizon-s", "30",
     "--pool-dist", "skew", "--pool-sizes", "12", "30", "60"],
    ["--users", "4", "--arrival", "replay", "--timestamps", "0", "0.5",
     "0.5", "2", "--class-mix", "interactive=0.2,batch=0.8",
     "--pool-dist", "cycle"],
    # chip_smoke.py phase 19's trace
    ["--seed", "7", "--users", "8", "--rate", "4.0", "--class-mix",
     "interactive=0.5,batch=0.5", "--pool-dist", "skew", "--pool-sizes",
     "150", "400", "--horizon-s", "2.0"],
]


def _run(main, argv, capsys):
    """``main(argv)``: (exit code, stdout), a ``SystemExit`` taken as its
    message and code."""
    try:
        rc = main(argv)
    except SystemExit as e:
        rc, msg = e.code, e.code
        if isinstance(msg, str):
            return 1, msg
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("args", GEN_ARGS,
                         ids=["poisson", "mmpp-churn", "replay", "phase19"])
def test_gen_and_digest_equal_jax(tmp_path, capsys, args):
    ours, theirs = str(tmp_path / "ours.jsonl"), str(tmp_path / "jax.jsonl")
    rc, out = _run(soak.main, ["gen", ours] + args, capsys)
    jrc, jout = _run(jax_soak.main, ["gen", theirs] + args, capsys)
    assert rc == jrc == 0
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    line, jline = json.loads(out), json.loads(jout)
    assert line.pop("trace") == ours and jline.pop("trace") == theirs
    assert line == jline
    for path in (ours, theirs):
        d = _run(soak.main, ["digest", path], capsys)
        assert d == _run(jax_soak.main, ["digest", path], capsys)
        assert json.loads(d[1])["trace_sha"] == line["trace_sha"]


@pytest.mark.parametrize("argv", [
    ["gen", "T", "--class-mix", "interactive"],
    ["gen", "T", "--class-mix", "interactive=x"],
    ["gen", "T", "--class-mix", ","],
    ["gen", "T", "--users", "0"],
    ["digest", "NOWHERE"],
], ids=["mix-no-value", "mix-nan", "mix-empty", "users-0", "missing"])
def test_bad_arguments_fail_alike(tmp_path, capsys, argv):
    argv = [str(tmp_path / a) if a in ("T", "NOWHERE") else a for a in argv]
    ours = _run(soak.main, argv, capsys)
    assert ours == _run(jax_soak.main, argv, capsys)
    assert ours[0] != 0 and "cetpu-soak" in ours[1]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A port ``amg_test --serve 2`` run: its users directory and the
    trace of its users, written by the port's ``soak gen``."""
    root = tmp_path_factory.mktemp("soak")
    roots = build_synth_roots(root, np.random.default_rng(1987))
    flags = ["--models-root", roots["models"], "--amg-root", roots["amg"],
             "--device", "cpu"]
    assert port_deam.main(["-cv", "2", "-m", "gnb", "--deam-root",
                           roots["deam"]] + flags) == 0
    assert amg_test.main(["-q", "3", "-e", "2", "-n", "10", "--max-users",
                          "3", "-m", "mc", "--serve", "2"] + flags) == 0
    trace = str(root / "trace.jsonl")
    assert soak.main(["gen", trace, "--users", "3"]) == 0
    return os.path.join(roots["models"], "users"), trace


@pytest.mark.parametrize("extra", [
    [], ["--slo", "interactive=5,batch=30", "--wall-s", "2.5"],
    ["--trace", "TRACE", "--no-gate"], ["--slo", "batch"],
], ids=["plain", "slo-wall", "trace", "bad-slo"])
def test_grade_equals_jax_on_the_same_run(run_dir, capsys, extra):
    users, trace = run_dir
    argv = ["grade", users, "--journal",
            os.path.join(users, "serve_journal.jsonl")] + [
        trace if a == "TRACE" else a for a in extra]
    ours = _run(soak.main, argv, capsys)
    assert ours == _run(jax_soak.main, argv, capsys)
    if extra[-1:] != ["batch"]:
        summary = json.loads(ours[1])
        assert summary["deterministic"]["journal_ok"]


def test_report_equals_jax_on_the_same_users_dir(run_dir, tmp_path,
                                                 capsys):
    users, _ = run_dir
    out = []
    for name, main in (("ours", report.main), ("jax", jax_report.main)):
        trace = str(tmp_path / f"{name}.json")
        assert main([users, "--validate", "--out", trace]) == 0
        cap = capsys.readouterr()
        with open(trace) as f:
            out.append((cap.out, cap.err.replace(trace, "T"), json.load(f)))
    assert out[0] == out[1]
    text, err, blob = out[0]
    assert "schema ok: 1 metrics file(s) valid" in err
    assert blob["traceEvents"] and text.strip()
    # a line off the schema makes both exit 1
    bad = tmp_path / "bad"
    bad.mkdir()
    with open(bad / "fleet_metrics.jsonl", "w") as f:
        f.write(json.dumps({"event": "enqueue", "t_s": "late"}) + "\n")
    assert report.main([str(bad), "--validate", "--no-text"]) == 1
    ours = capsys.readouterr().err
    assert jax_report.main([str(bad), "--validate", "--no-text"]) == 1
    assert ours == capsys.readouterr().err
