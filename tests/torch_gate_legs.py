"""The gate test files' driver: ``cli/fault_matrix.py`` legs run at once,
each CLI (``--device cpu``) in a process of its own (a leg's coordinator
kills are process-wide fault rules), and the replay of every journal and
WAL a leg leaves in both packages."""

import glob
import json
import os
import subprocess
import sys

from consensus_entropy_tpu.serve import AdmissionJournal as JaxJournal
from consensus_entropy_tpu.serve import (
    validate_journal_file as jax_validate,
)
from consensus_entropy_tpu_torch.serve import AdmissionJournal
from consensus_entropy_tpu_torch.serve import validate_journal_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_legs(root, legs, timeout_s) -> dict:
    """``{leg: (its root, its exit code, its JSON line)}`` of ``legs``
    run at once under ``root``; a leg still running after ``timeout_s``
    (all together) is killed with its workers and fails."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + (os.pathsep + os.environ["PYTHONPATH"]
                                  if os.environ.get("PYTHONPATH") else ""))
    env.pop("CETPU_FAULTS", None)
    procs = {leg: subprocess.Popen(
        [sys.executable, "-m", "consensus_entropy_tpu_torch.cli."
         "fault_matrix", "--leg", leg, "--device", "cpu", "--root",
         str(root / leg)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for leg in legs}
    out = {}
    try:
        for leg, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=timeout_s)
            lines = [json.loads(line) for line in stdout.splitlines()
                     if line.startswith("{")]
            rec = lines[-1] if lines else {
                "ok": False, "error": f"no JSON line:\n{stderr[-3000:]}"}
            out[leg] = (root / leg, proc.returncode, rec)
    finally:
        # a wedged leg: its workers exit with their coordinator
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def users_dirs(leg_root, leg) -> list:
    """The users directories of the leg's fabrics and serve cohorts, named
    after the leg (``tree`` is the registry's)."""
    return sorted(glob.glob(os.path.join(str(leg_root), f"{leg}*",
                                         "models", "users")))


def replay_in_both(users) -> list:
    """Each journal and WAL under ``users`` (its ``serve_journal.jsonl``,
    and a fabric's ``fabric/events_*.jsonl``) validates under both
    packages and replays in the JAX package's ``AdmissionJournal`` to the
    port's state; returns the paths checked."""
    paths = [os.path.join(users, "serve_journal.jsonl"),
             *sorted(glob.glob(os.path.join(users, "fabric",
                                            "events_*.jsonl")))]
    for path in paths:
        assert jax_validate(path) == [], path
        assert validate_journal_file(path) == [], path
        theirs, ours = JaxJournal(path), AdmissionJournal(path)
        try:
            assert theirs.state.to_dict() == ours.state.to_dict(), path
        finally:
            theirs.close()
            ours.close()
    return paths


def finishes(users) -> dict:
    """``{user: [host, ...]}`` of every ``finish`` that ran a user (not a
    ``skipped`` one) across a fabric's event WALs."""
    from consensus_entropy_tpu_torch.obs import export

    ran = {}
    for wal in sorted(glob.glob(os.path.join(users, "fabric",
                                             "events_*.jsonl"))):
        host = os.path.basename(wal)[len("events_"):-len(".jsonl")]
        for rec in export.read_jsonl_tolerant(wal):
            if rec.get("event") == "finish" and not rec.get("skipped"):
                ran.setdefault(str(rec["user"]), []).append(host)
    return ran
