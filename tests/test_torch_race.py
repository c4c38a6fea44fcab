"""The port's host core under ThreadSanitizer and oversubscribed OpenMP
(``python -m consensus_entropy_tpu_torch.cli.race_check`` at its small
default sizes): four concurrent callers of every exported core function
(the host members' predictions, the segment mean and the row entropy of
``native/ce_host.cpp`` among them) under TSAN, then every output bytewise
equal across repeat runs and across OpenMP teams of 2, nproc, 2x and 4x
nproc.  Skipped, with the probe of
``tests/test_native.py``, where the toolchain lacks ThreadSanitizer;
measured about 25 s here (two compiles in parallel, then the runs)."""

import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from consensus_entropy_tpu_torch.cli import race_check

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_race_check_passes(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    probe = subprocess.run(
        ["g++", "-fsanitize=thread", "-fopenmp", "-x", "c++", "-", "-o",
         str(tmp_path / "probe")],
        input="int main(){return 0;}", text=True, capture_output=True)
    if probe.returncode != 0:
        pytest.skip("toolchain lacks ThreadSanitizer support")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "consensus_entropy_tpu_torch.cli.race_check"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    wall = time.perf_counter() - t0
    assert res.returncode == 0, res.stdout + res.stderr
    assert "race check passed" in res.stdout
    cores = len(os.sched_getaffinity(0))
    for t in race_check.thread_counts(cores):
        assert f"OMP_NUM_THREADS={t} (x3): 38 outputs bytewise equal" \
            in res.stdout
    assert "tsan stress ok: 4 callers, 38 outputs equal" in res.stdout
    print(f"race check: {wall:.1f} s")


def test_thread_counts_and_refusals():
    assert race_check.thread_counts(8) == [2, 8, 16, 32]
    assert race_check.thread_counts(1) == [2, 4]
    assert race_check.thread_counts(2) == [2, 4, 8]
    with pytest.raises(ValueError):
        race_check.run(passes=("tsan", "helgrind"))
    with pytest.raises(ValueError):
        race_check.run(passes=("determinism",), threads=[0])
    assert race_check.main(["--threads", "2,0"]) == 1
