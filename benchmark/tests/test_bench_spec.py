"""The harness finds a cell's parts by name, and a cell added as files
alone runs end to end (on the CPU, skipping the look for a card)."""

import time

import pytest

from benchmark import run, spec
from benchmark.tests.conftest import REPO, add_cell


def test_committed_cells_resolve():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.resolve(bench, w["name"])
        assert cell.config["cnn"]["arch"] in ("vgg", "res")
        assert cell.traffic["kind"] == "cohort"
        assert spec.driver(cell.traffic).run
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]))
        assert set(cell.limits) >= {"select_gap", "f1_gap", "retrain_gap",
                                    "host_gap"}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.resolve(spec.load_benchmark(), "no.such-cell")


@pytest.mark.parametrize("traffic", ["tiny-cohort", "tiny-fullsong"])
def test_cell_added_as_files_runs(tmp_path, traffic):
    bench, here = add_cell(tmp_path, traffic)
    cell = spec.resolve(bench, "tiny.cohort2-mc", root=tmp_path, here=here)
    assert cell.here == here
    line = run.run_cell(cell, 2 ** 31 + 7, 2.0, False, "cpu",
                        t_start=time.time(), log=lambda m: None)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"user_iters_per_s", "iter_ms",
                                    "setup_s"}
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu"


def test_traced_run_on_the_cpu_reads_no_device_metric(tmp_path):
    bench, here = add_cell(tmp_path)
    cell = spec.resolve(bench, "tiny.cohort2-mc", root=tmp_path, here=here)
    line = run.run_cell(cell, 3, 2.0, True, "cpu", t_start=time.time(),
                        log=lambda m: None)
    assert line["correct"], line["checks"]
    # no CUDA event: nothing read from a device trace, no share of a peak
    for name in ("mfu", "conv_roofline", "device_idle",
                 "fleet.host_overlap", "score_ms"):
        assert name not in line["metrics"]
    assert "host_step_ms" in line["metrics"]
    assert line["device"]["busy_s"] == 0


def test_command_refuses_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "vgg.cohort4-mc", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert (REPO / ".bench_cache").is_dir()
