"""The port's sequential AL CLI against the JAX package's, on the CPU.

The JAX pre-training CLI fits GaussianNB and SGD registries on a synthetic
DEAM tree; ``convert.registry_from_jax`` carries them across; both AL CLIs
personalize the same synthetic AMG1608 users and write equal
``metrics.jsonl`` files (queried songs equal, F1s equal exactly: tolerance
0).  A rerun skips completed users; a registry the port cannot load yet
exits 1 with the reason.  The port's own pre-training CLI writes the
registry the JAX CLI writes (the same files, metrics and members), which
personalizes to the same users; the evidence CLI's sweep and analyze
reports equal the JAX CLI's."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.cli import amg_test as jax_amg_test
from consensus_entropy_tpu.cli import deam_classifier
from consensus_entropy_tpu.cli import evidence as jax_evidence_cli
from consensus_entropy_tpu_torch import convert
from consensus_entropy_tpu_torch.al import evidence
from consensus_entropy_tpu_torch.cli import amg_test
from consensus_entropy_tpu_torch.cli import deam_classifier as port_deam
from consensus_entropy_tpu_torch.cli import evidence as evidence_cli
from tests.synth_data import build_synth_roots

torch.set_num_threads(1)

AL = ["-q", "4", "-e", "3", "-n", "10", "--max-users", "2"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Synthetic DEAM + AMG trees, a JAX registry (2 folds each of gnb and
    sgd) and the port's conversion of it."""
    root = tmp_path_factory.mktemp("cli")
    roots = build_synth_roots(root, np.random.default_rng(1987))
    jax_flags = ["--models-root", roots["models"], "--deam-root",
                 roots["deam"], "--amg-root", roots["amg"], "--device", "cpu"]
    for model in ("gnb", "sgd"):
        assert deam_classifier.main(["-cv", "2", "-m", model]
                                    + jax_flags) == 0
    port_models = str(root / "port_models")
    written = convert.registry_from_jax(
        os.path.join(roots["models"], "pretrained"),
        os.path.join(port_models, "pretrained"))
    assert len(written) == 4 and all(f.endswith(".npz") for f in written)
    return roots, jax_flags, port_models


def _user_metrics(models_root, mode):
    users = os.path.join(models_root, "users")
    out = {}
    for u in sorted(os.listdir(users)):
        if not os.path.isdir(os.path.join(users, u, mode)):
            continue  # fleet_metrics.jsonl, the operator plane's status/
        with open(os.path.join(users, u, mode, "metrics.jsonl")) as f:
            out[u] = [json.loads(line) for line in f]
    return out


def _port_flags(roots, models_root):
    return ["--models-root", models_root, "--amg-root", roots["amg"],
            "--device", "cpu"]


@pytest.mark.parametrize("mode", ["mc", "hc"])
def test_cli_matches_the_jax_cli(trees, capsys, mode):
    roots, jax_flags, port_models = trees
    assert jax_amg_test.main(AL + ["-m", mode] + jax_flags) == 0
    assert amg_test.main(AL + ["-m", mode]
                         + _port_flags(roots, port_models)) == 0
    ours = _user_metrics(port_models, mode)
    theirs = _user_metrics(roots["models"], mode)
    assert sorted(ours) == sorted(theirs) and len(ours) == 2
    for u in ours:
        assert len(ours[u]) == 4
        for a, b in zip(ours[u], theirs[u]):
            assert a.get("queried") == b.get("queried")
            assert a["f1"] == b["f1"]  # tolerance 0
    for u in ours:  # the members were saved back and the user is done
        udir = os.path.join(port_models, "users", u, mode)
        assert os.path.exists(os.path.join(udir, "DONE"))
        assert sum(f.endswith(".npz") for f in os.listdir(udir)) == 4
    capsys.readouterr()
    assert amg_test.main(AL + ["-m", mode]
                         + _port_flags(roots, port_models)) == 0
    assert capsys.readouterr().out.count("Skipping user") == 2


@pytest.mark.parametrize("extra, reason", [
    ("classifier_xgb.it_0.pkl", "boosted-trees"),
    ("classifier_cnn.it_0.msgpack", "CNN"),
    ("classifier_gnb.it_9.pkl", "registry_from_jax"),
])
def test_unported_registry_exits_with_the_reason(trees, tmp_path, capsys,
                                                 extra, reason):
    roots, _, port_models = trees
    models = str(tmp_path / "models")
    shutil.copytree(os.path.join(port_models, "pretrained"),
                    os.path.join(models, "pretrained"))
    open(os.path.join(models, "pretrained", extra), "wb").close()
    assert amg_test.main(AL + ["-m", "mc"] + _port_flags(roots, models)) == 1
    assert reason in capsys.readouterr().out
    assert not os.path.exists(os.path.join(models, "users"))


def test_qbdc_and_missing_registry_exit_cleanly(trees, tmp_path, capsys):
    roots, _, port_models = trees
    assert amg_test.main(AL + ["-m", "qbdc"]
                         + _port_flags(roots, port_models)) == 1
    assert "CNN" in capsys.readouterr().out
    assert amg_test.main(AL + ["-m", "mc"]
                         + _port_flags(roots, str(tmp_path / "none"))) == 1
    assert "No pre-trained models" in capsys.readouterr().out


def test_fleet_cli_matches_the_sequential_cli(trees, tmp_path, capsys):
    """``--fleet 2`` runs the two users as one cohort: each user's
    ``metrics.jsonl`` equals the sequential CLI's (tolerance 0), and the
    cohort's ``fleet_metrics.jsonl`` ends with its summary."""
    roots, _, port_models = trees
    runs = {}
    for name, extra in (("seq", []), ("fleet", ["--fleet", "2",
                                                 "--fleet-host-workers",
                                                 "2"])):
        models = str(tmp_path / name)
        shutil.copytree(os.path.join(port_models, "pretrained"),
                        os.path.join(models, "pretrained"))
        assert amg_test.main(AL + ["-m", "mix"] + extra
                             + _port_flags(roots, models)) == 0
        runs[name] = models
    assert "Fleet cohort of 2 users" in capsys.readouterr().out
    ours = _user_metrics(runs["fleet"], "mix")
    assert len(ours) == 2 and ours == _user_metrics(runs["seq"], "mix")
    for u in ours:
        assert os.path.exists(os.path.join(runs["fleet"], "users", u,
                                           "mix", "DONE"))
    with open(os.path.join(runs["fleet"], "users",
                           "fleet_metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    assert [e["event"] for e in events].count("user_done") == 2
    assert events[-1]["event"] == "fleet_summary"
    # how many users share a dispatch depends on host timing; the stacked
    # path itself is held in test_torch_fleet.py
    assert events[-1]["score_dispatches"] >= 1
    assert 0 < events[-1]["occupancy"] <= 1.0


@pytest.mark.parametrize("extra", [
    ["--fleet", "0"],
    ["--no-stack-cnn"],
    ["--plan-chunk", "2"],
    ["--plan-chunk", "0", "--fleet", "2"],
], ids=["fleet-0", "no-stack-cnn-alone", "plan-chunk-alone",
        "plan-chunk-0"])
def test_fleet_flag_errors_are_the_jax_clis(trees, capsys, extra):
    roots, jax_flags, port_models = trees
    assert jax_amg_test.main(AL + ["-m", "mc"] + extra + jax_flags) == 1
    theirs = capsys.readouterr().out
    assert amg_test.main(AL + ["-m", "mc"] + extra
                         + _port_flags(roots, port_models)) == 1
    assert capsys.readouterr().out == theirs
    assert "--" in theirs


def test_pretraining_cli_then_amg_test_match_jax(trees, tmp_path, capsys):
    """``deam_classifier -cv 2`` for gnb, sgd and xgb, then ``amg_test -m
    mc`` and ``-m rand`` on the registry, in both packages: equal
    pre-training metrics and file names, equal users' metrics, and
    ``evidence analyze`` over the users directory equal."""
    roots, _, _ = trees
    models = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    for model in ("gnb", "sgd", "xgb"):
        for name, cli in (("jax", deam_classifier), ("port", port_deam)):
            assert cli.main(["-cv", "2", "-m", model, "--models-root",
                             models[name], "--deam-root", roots["deam"],
                             "--device", "cpu"]) == 0
    pre = {k: os.path.join(v, "pretrained") for k, v in models.items()}
    with open(os.path.join(pre["jax"], "pretrain_metrics.jsonl")) as a, \
            open(os.path.join(pre["port"], "pretrain_metrics.jsonl")) as b:
        assert a.read() == b.read()
    converted = convert.registry_from_jax(pre["jax"], str(tmp_path / "conv"))
    assert sorted(converted) == sorted(
        f for f in os.listdir(pre["port"]) if f.endswith(".npz")) == [
        f"classifier_{m}.it_{i}.npz" for m in ("gnb", "sgd", "xgb")
        for i in (0, 1)]
    flags = ["--amg-root", roots["amg"], "--device", "cpu"]
    for mode in ("mc", "rand"):
        assert jax_amg_test.main(AL + ["-m", mode, "--models-root",
                                       models["jax"]] + flags) == 0
        assert amg_test.main(AL + ["-m", mode, "--models-root",
                                   models["port"]] + flags) == 0
        ours, theirs = (_user_metrics(models[k], mode)
                        for k in ("port", "jax"))
        assert len(ours) == 2
        for u in ours:
            assert [(r.get("queried"), r["f1"]) for r in ours[u]] == \
                [(r.get("queried"), r["f1"]) for r in theirs[u]]
    capsys.readouterr()
    users = os.path.join(models["port"], "users")
    out = {}
    for name, cli in (("jax", jax_evidence_cli), ("port", evidence_cli)):
        path = str(tmp_path / f"{name}_analyze.json")
        assert cli.main(["analyze", users, "--out", path,
                         "--device", "cpu"]) == 0
        with open(path) as f:
            out[name] = json.load(f)
    assert out["port"] == out["jax"]
    assert out["port"]["tests"]["mc>rand"]["n_users_paired"] == 2
    assert out["port"] == evidence.analyze_users(users)


def test_evidence_sweep_cli_matches_jax(tmp_path, capsys):
    reports = {}
    for name, cli in (("jax", jax_evidence_cli), ("port", evidence_cli)):
        out = str(tmp_path / f"{name}.json")
        assert cli.main(["sweep", "--seeds", "2", "--epochs", "2",
                         "--songs", "80", "--sgd-members", "1", "--out", out,
                         "--workdir", str(tmp_path / name),
                         "--device", "cpu"]) == 0
        with open(out) as f:
            reports[name] = json.load(f)
        capsys.readouterr()
    assert reports["port"] == reports["jax"]
    assert set(reports["port"]["tests"]) == {"mc>rand", "hc>rand",
                                             "mix>rand"}


def _fresh_models(port_models, root):
    shutil.copytree(os.path.join(port_models, "pretrained"),
                    os.path.join(root, "pretrained"))
    return str(root)


def test_serve_cli_matches_the_sequential_cli(trees, tmp_path, capsys):
    """``--serve 2`` selects the sequential CLI's songs for each user
    (tolerance 0); its spans go to ``--trace-dir`` without orphans, its
    journal shows every user finished, its metrics stream validates, and
    ``--torch-profile`` writes a Chrome trace of the first dispatches; a
    rerun skips the finished users."""
    from consensus_entropy_tpu_torch.obs import export
    from consensus_entropy_tpu_torch.serve import journal

    roots, _, port_models = trees
    seq = _fresh_models(port_models, tmp_path / "seq")
    assert amg_test.main(AL + ["-m", "mc"] + _port_flags(roots, seq)) == 0
    served = _fresh_models(port_models, tmp_path / "serve")
    spans, prof = str(tmp_path / "spans"), str(tmp_path / "prof")
    flags = AL + ["-m", "mc", "--serve", "2", "--bucket-widths", "64,128",
                  "--trace-dir", spans, "--torch-profile", prof,
                  "--torch-profile-n", "3"] + _port_flags(roots, served)
    assert amg_test.main(flags) == 0
    out = capsys.readouterr().out
    assert "serve summary: " in out and "device profile: " in out
    ours = _user_metrics(served, "mc")
    assert len(ours) == 2 and ours == _user_metrics(seq, "mc")
    users = os.path.join(served, "users")
    st = journal._replay(os.path.join(users, "serve_journal.jsonl"))
    assert st.finished == set(ours)
    assert export.validate_metrics_file(
        os.path.join(users, "fleet_metrics.jsonl")) == []
    merged = export.load_spans(export.find_span_files(spans))
    assert merged and export.orphan_spans(merged) == []
    assert {"run", "user", "al_iter"} <= {s["name"] for s in merged}
    (trace_file,) = os.listdir(prof)
    with open(os.path.join(prof, trace_file)) as f:
        assert json.load(f)["traceEvents"]
    assert amg_test.main(flags) == 0
    out = capsys.readouterr().out
    assert "recovering — 2 finished" in out
    assert out.count("Skipping user") == 2
    assert journal._replay(os.path.join(
        users, "serve_journal.jsonl")).finished == set(ours)


@pytest.mark.parametrize("kill_at", [3, 6])
def test_serve_cli_killed_at_a_journal_append_restarts(trees, tmp_path,
                                                       capsys, kill_at):
    """Killed at the K-th ``serve.journal.append``, the same command
    restarted from the journal loses no user, skips the finished ones and
    ends on the sequential CLI's songs."""
    from consensus_entropy_tpu_torch.resilience import faults
    from consensus_entropy_tpu_torch.resilience.faults import FaultRule
    from consensus_entropy_tpu_torch.serve import journal

    roots, _, port_models = trees
    seq = _fresh_models(port_models, tmp_path / "seq")
    assert amg_test.main(AL + ["-m", "hc"] + _port_flags(roots, seq)) == 0
    served = _fresh_models(port_models, tmp_path / "serve")
    flags = AL + ["-m", "hc", "--serve", "2"] + _port_flags(roots, served)
    with faults.inject(FaultRule("serve.journal.append", "kill",
                                 at=kill_at)) as inj:
        with pytest.raises(faults.InjectedKill):
            amg_test.main(flags)
    assert inj.fired
    jpath = os.path.join(served, "users", "serve_journal.jsonl")
    finished = journal._replay(jpath).finished
    users = os.path.join(served, "users")
    # a user persisted by on_result whose finish record the kill cut off
    # is DONE on disk: the restart skips it as a finished workspace
    done = {u for u in os.listdir(users)
            if os.path.exists(os.path.join(users, u, "hc", "DONE"))}
    assert finished <= done
    capsys.readouterr()
    assert amg_test.main(flags) == 0
    out = capsys.readouterr().out
    assert "serve journal: recovering" in out
    assert out.count("final mean F1") == 2 - len(done)
    assert out.count("Skipping user") == len(done)
    ours = _user_metrics(served, "hc")
    assert len(ours) == 2 and ours == _user_metrics(seq, "hc")
    for u in ours:
        assert os.path.exists(os.path.join(users, u, "hc", "DONE"))
    assert journal._replay(jpath).finished | done == set(ours)
    assert bool(done) == (kill_at == 6)  # 6: the second finish record


@pytest.mark.parametrize("extra", [
    ["--fleet", "2", "--serve", "2"],
    ["--serve", "0"],
    ["--serve", "2", "--pad-pool-to", "64"],
    ["--serve", "2", "--mesh", "auto"],
    ["--serve", "2", "--distributed", "127.0.0.1:1,1,0"],
    ["--admit-window-ms", "5"],
    ["--watchdog-s", "1"],
    ["--no-serve-journal"],
    ["--serve", "2", "--failure-budget", "0"],
    ["--serve", "2", "--slo-batch-s", "0"],
    ["--bucket-widths", "8,16"],
    ["--serve", "2", "--bucket-widths", "x"],
    ["--serve", "2", "--bucket-widths", "16,8"],
    ["--serve", "2", "--mesh", "3"],
], ids=["fleet-and-serve", "serve-0", "pad-pool-to", "mesh-auto",
        "distributed", "admit-window-alone", "watchdog-alone",
        "journal-alone", "budget-0", "slo-0", "widths-alone", "widths-x",
        "widths-unsorted", "mesh-3"])
def test_serve_flag_errors_are_the_jax_clis(trees, capsys, extra):
    roots, jax_flags, port_models = trees
    assert jax_amg_test.main(AL + ["-m", "mc"] + extra + jax_flags) == 1
    theirs = capsys.readouterr().out
    assert amg_test.main(AL + ["-m", "mc"] + extra
                         + _port_flags(roots, port_models)) == 1
    assert capsys.readouterr().out == theirs
    assert "--" in theirs


def test_torch_profile_needs_the_engine_and_unpoison(trees, tmp_path,
                                                     capsys):
    """``--torch-profile`` (the JAX CLI's ``--jax-profile``) is refused
    without ``--fleet`` or ``--serve``; ``--unpoison`` removes a poisoned
    user with a journaled record and reports one that is not listed."""
    from consensus_entropy_tpu_torch.serve import journal

    roots, _, port_models = trees
    assert amg_test.main(AL + ["-m", "mc", "--torch-profile", "p"]
                         + _port_flags(roots, port_models)) == 1
    assert "--torch-profile" in capsys.readouterr().out
    models = str(tmp_path)
    users = os.path.join(models, "users")
    os.makedirs(users)
    plist = journal.PoisonList(os.path.join(users, "serve_poison.jsonl"))
    plist.add("7", error="boom", attempts=3)
    plist.close()
    jr = journal.AdmissionJournal(os.path.join(users,
                                               "serve_journal.jsonl"))
    jr.append("poison", "7", error="boom", attempts=3)
    jr.close()
    flags = AL + ["-m", "mc", "--unpoison", "7,8"] + _port_flags(roots,
                                                                 models)
    assert amg_test.main(flags) == 1  # 8 was not on the list
    out = capsys.readouterr().out
    assert "unpoisoned user 7" in out and "user 8 is not" in out
    assert "7" not in journal.PoisonList(os.path.join(
        users, "serve_poison.jsonl"))
    st = journal._replay(os.path.join(users, "serve_journal.jsonl"))
    assert st.last["7"] == "unpoison" and "7" not in st.admits
