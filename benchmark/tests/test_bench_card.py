"""On the card: the control comes out not correct where the system is.

The control is the plain reference computed in TF32, the nearest
precision below the float32 with TF32 off that the configurations state,
put in the system's place at the iterations a run compares.  One run of
the cell at its own size (a 51-s window, so that it compares as many
iterations as a benchmark run does): the system's numbers are within
their limits, the control's are not.  About four minutes."""

import time

import pytest

from benchmark import run, spec


@pytest.mark.card
@pytest.mark.parametrize("workload", ["vgg.cohort4-mc"])
def test_control_is_not_correct(card, workload):
    cell = spec.resolve(spec.load_benchmark(), workload)
    line = run.run_cell(cell, 1234567, 51.0, False, card,
                        t_start=time.time(), control=True)
    assert line["correct"], line["checks"]
    assert any(line["control"][f"control_{k}"] > v["limit"]
               for k, v in line["checks"].items()), line["control"]
