"""``fsck`` over a port tree and a JAX tree, on the CPU.

A users directory written by the port's ``amg_test --serve 2`` (journal,
workspaces of ``.npz`` members, a knn one among them, and
``al_state.json``, the operator plane's status files) checks clean; a
byte flipped in a journal's middle line and one in a member file are
both named (exit 1), ``--repair`` quarantines the WAL line and removes a
stale ``.tmp`` while the member stays reported (exit 1), and the
repaired journal validates; a live WAL makes repair impossible (exit 2).
On a JAX tree (the JAX package's journal and ``CETPU1`` checkpoints from
its own writer, ``tests/test_durability.py:415-470`` of the JAX package)
the port's fsck gives the JAX fsck's exit codes and report: its JSON
keys equal, its text lines in the same order, the port's AL-state lines
besides."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.cli import fsck as jax_fsck
from consensus_entropy_tpu.serve.journal import (
    AdmissionJournal as JaxJournal,
)
from consensus_entropy_tpu_torch.al.state import ALState
from consensus_entropy_tpu_torch.cli import amg_test
from consensus_entropy_tpu_torch.cli import deam_classifier as port_deam
from consensus_entropy_tpu_torch.cli import fsck
from consensus_entropy_tpu_torch.resilience import io as dio
from consensus_entropy_tpu_torch.serve.journal import (
    AdmissionJournal,
    validate_journal_file,
)
from tests.synth_data import build_synth_roots

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port serve run's users directory (3 users, 5 members each)."""
    root = tmp_path_factory.mktemp("fsck")
    roots = build_synth_roots(root, np.random.default_rng(1987))
    flags = ["--models-root", roots["models"], "--deam-root", roots["deam"],
             "--amg-root", roots["amg"], "--device", "cpu"]
    for model, cv in (("gnb", "2"), ("sgd", "2"), ("knn", "1")):
        assert port_deam.main(["-cv", cv, "-m", model] + flags) == 0
    assert amg_test.main(["-q", "3", "-e", "2", "-n", "10", "--max-users",
                          "3", "-m", "mc", "--serve", "2"] + flags[:2]
                         + flags[4:]) == 0
    return os.path.join(roots["models"], "users")


def _copy(users, tmp_path):
    dst = str(tmp_path / "users")
    shutil.copytree(users, dst)
    return dst


def _flip_byte(path, line_no=None):
    """Flip one byte: mid-line ``line_no`` of a text file, or the middle
    byte of a binary one."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if line_no is None:
        off = len(data) // 2
    else:
        starts = [0] + [i + 1 for i, b in enumerate(data) if b == 0x0A]
        off = (starts[line_no] + starts[line_no + 1]) // 2
    data[off] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))


def test_a_clean_port_tree_checks_clean(served, capsys):
    assert fsck.main([served]) == 0
    out = capsys.readouterr().out
    assert "cetpu-fsck: clean" in out
    report = fsck.scan_users_dir(served)
    assert [os.path.basename(s["path"]) for s in report["wals"]] == [
        "serve_journal.jsonl"]
    kinds = {os.path.basename(m["path"]).split(".")[0]
             for m in report["members"]}
    assert kinds == {"classifier_gnb", "classifier_sgd", "classifier_knn"}
    assert len(report["members"]) == 3 * 5 * 2  # and the last-good copy
    assert len(report["states"]) == 3 * 2  # each generation's state
    assert not any(m["error"] for m in report["members"] + report["states"])
    assert report["checkpoints"] == [] and report["journal_errors"] == []
    # fsck's copy of the state's fields is ALState's
    import dataclasses

    names = [f.name for f in dataclasses.fields(ALState)]
    assert names == list(fsck.STATE_FIELDS) + list(fsck.STATE_OPTIONAL)


def test_flipped_bytes_are_found_and_the_wal_repaired(served, tmp_path,
                                                      capsys):
    d = _copy(served, tmp_path)
    jp = os.path.join(d, "serve_journal.jsonl")
    with open(jp, "rb") as f:
        n_lines = f.read().count(b"\n")
    _flip_byte(jp, n_lines // 2)
    member = next(m["path"] for m in fsck.scan_users_dir(d)["members"]
                  if "classifier_sgd" in m["path"])
    _flip_byte(member)
    open(member + ".tmp", "wb").close()  # a killed writer's leftover
    assert fsck.main([d]) == 1
    out = capsys.readouterr().out
    assert f"wal  {jp}: {n_lines} line(s), 1 corrupt" in out
    assert f"npz  {member}: CRC32 mismatch" in out
    assert f"tmp  {member}.tmp" in out
    assert fsck.main([d, "--repair"]) == 1  # the member stays corrupt
    out = capsys.readouterr().out
    assert "quarantined 1 line(s)" in out and "removed" in out
    assert "0 WAL/journal error(s) and 1 corrupt checkpoint(s)" in out
    assert os.path.exists(dio.quarantine_path(jp))
    assert not os.path.exists(member + ".tmp")
    assert validate_journal_file(jp) == []
    report = fsck.scan_users_dir(d)
    assert [m["path"] for m in report["members"] if m["error"]] == [member]
    # a state file that does not parse, or lacks a field, is named too
    state = next(s["path"] for s in report["states"])
    with open(state) as f:
        rec = json.load(f)
    del rec["key_data"]
    with open(state, "w") as f:
        json.dump(rec, f)
    assert fsck.verify_state(state) == "lacks 'key_data'"
    with open(state, "w") as f:
        f.write('{"next_epoch": 1, "traj')
    assert fsck.verify_state(state) == "unparseable JSON"


def test_a_live_wal_cannot_be_repaired(served, tmp_path):
    d = _copy(served, tmp_path)
    jp = os.path.join(d, "serve_journal.jsonl")
    j = AdmissionJournal(jp)
    j.append("enqueue", "live")  # the first append takes the lock
    _flip_byte(jp, 2)
    try:
        assert fsck.main([d, "--repair"]) == 2
        assert not os.path.exists(dio.quarantine_path(jp))
    finally:
        j.close()
    assert fsck.main([str(tmp_path / "nowhere")]) == 2


def _jax_users_dir(tmp_path):
    """A JAX tree: its journal, a workspace holding a CETPU1 member
    checkpoint from the JAX writer and an AL state file, a poison list."""
    from consensus_entropy_tpu.serve.journal import PoisonList
    from consensus_entropy_tpu.utils.checkpoint import save_variables

    d = str(tmp_path / "users")
    ws = os.path.join(d, "u0", "mc")
    os.makedirs(ws)
    with JaxJournal(os.path.join(d, "serve_journal.jsonl")) as j:
        for i in range(5):
            j.append("enqueue", f"u{i}")
            j.append("admit", f"u{i}")
        j.append("finish", "u0")
    PoisonList(os.path.join(d, "serve_poison.jsonl")).close()
    save_variables(os.path.join(ws, "classifier_cnn.it_0.msgpack"),
                   {"params": {"w": np.arange(12, dtype=np.float32)}},
                   {"kind": "cnn"})
    with open(os.path.join(ws, "al_state.json"), "w") as f:
        json.dump({"next_epoch": 1, "trajectory": [0.5], "train_songs": [],
                   "test_songs": [], "queried": [["1"]],
                   "key_data": [0, 7], "key_dtype": "uint32", "mode": "mc",
                   "seed": 3, "queries": 1, "train_size": 0.8,
                   "member_weights": None}, f)
    return d


def _damaged_jax_tree(root, damage):
    d = _jax_users_dir(root)
    if damage == "journal":
        _flip_byte(os.path.join(d, "serve_journal.jsonl"), 3)
        open(os.path.join(d, "serve_journal.jsonl.tmp"), "wb").close()
    elif damage == "checkpoint":
        ck = os.path.join(d, "u0", "mc", "classifier_cnn.it_0.msgpack")
        with open(ck, "r+b") as f:
            f.seek(-5, os.SEEK_END)
            f.write(b"\xff")
    return d


def _jax_lines(text):
    """The report's lines without the port's AL-state lines."""
    return [ln for ln in text.splitlines() if not ln.startswith("  state ")]


@pytest.mark.parametrize("damage", ["none", "journal", "checkpoint"])
def test_a_jax_tree_gets_the_jax_report(tmp_path, capsys, damage):
    d = _damaged_jax_tree(tmp_path, damage)
    want_rc = {"none": 0, "journal": 1, "checkpoint": 1}[damage]
    assert jax_fsck.main([d, "--json"]) == want_rc
    jtext, _, jjson = capsys.readouterr().out.partition("{")
    assert fsck.main([d, "--json"]) == want_rc
    ptext, _, pjson = capsys.readouterr().out.partition("{")
    theirs, ours = json.loads("{" + jjson), json.loads("{" + pjson)
    assert {k: ours[k] for k in theirs} == theirs
    assert [m["path"] for m in ours["states"]] == [
        os.path.join(d, "u0", "mc", "al_state.json")]
    assert ours["members"] == [] and ours["states"][0]["error"] is None
    assert _jax_lines(ptext) == jtext.splitlines()
    # --repair, each package on its own copy of the damaged tree
    twin = str(tmp_path / "twin")
    shutil.copytree(d, twin)
    want_rc = 1 if damage == "checkpoint" else 0
    assert jax_fsck.main([d, "--repair"]) == want_rc
    theirs = capsys.readouterr().out.replace(d, "D")
    assert fsck.main([twin, "--repair"]) == want_rc
    ours = capsys.readouterr().out.replace(twin, "D")
    assert _jax_lines(ours) == theirs.splitlines()
