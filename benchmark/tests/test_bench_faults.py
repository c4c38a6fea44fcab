"""A run with the timed path broken underneath comes out not correct.

Each run skips the look for a card and drives the rest of a run of the
tiny cell on the CPU, with one fault of ``benchmark.faults`` planted: a
retrain that returns the state unchanged, leaves half of each batch out,
runs one epoch or keeps its last; a consensus mean over half the
committee; an answer altered where it is produced; a host update left
out, or one member kind's update gone wrong.  A run on one card has no
exchange between chips to leave out."""

import time

import pytest

from benchmark import run, spec
from benchmark.faults import FAULTS, planted
from benchmark.tests.conftest import add_cell

#: the compared number each fault has to move past its limit
CATCHES = {"unchanged_retrain": "retrain_gap", "half_batch": "retrain_gap",
           "fewer_epochs": "retrain_one_epoch",
           "last_epoch": "retrain_one_epoch",
           "half_mean": "select_gap", "altered_answer": "select_gap",
           "skipped_update": "host_gap", "gnb_restart": "host_gap",
           "sgd_restart": "host_gap", "gbdt_no_lambda": "host_gap"}


@pytest.fixture
def cell(tmp_path):
    bench, here = add_cell(tmp_path)
    return spec.resolve(bench, "tiny.cohort2-mc", root=tmp_path, here=here)


def test_sound_run_is_correct(cell):
    line = run.run_cell(cell, 41, 2.0, False, "cpu", t_start=time.time(),
                        log=lambda m: None)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(cell, fault):
    with planted([fault]):
        line = run.run_cell(cell, 41, 2.0, False, "cpu",
                            t_start=time.time(), log=lambda m: None)
    assert not line["correct"]
    check = line["checks"][CATCHES[fault]]
    assert check["value"] > check["limit"], line["checks"]
