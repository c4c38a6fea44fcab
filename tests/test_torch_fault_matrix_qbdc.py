"""The qbdc rows of the JAX package's kill matrix against the port, on the
CPU (``tests/test_resilience.py:146-186``).

The committee is GaussianNB, SGD and two narrow vgg members, the user of
``tests/test_torch_cnn_fleet.py::_user`` (``cli/fault_matrix.py``'s
``qbdc_user`` draws it again without JAX: the same frames, waveforms and
fits, each vgg initialized as Flax does).  The port's unfaulted run
queries the JAX package's songs, its host members' F1s equal and its vgg
members' within 1e-6 (C4: CNN retraining, as ``test_torch_serve.py``
holds the qbdc server).  A run killed at the mask draw, the score, the
state commit or a vgg member's file resumes through
``workspace.load_committee`` to the unfaulted run.  One unfaulted run hits
each fault point as often in the port as in the JAX package."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.al.loop import ALLoop as JaxLoop
from consensus_entropy_tpu.al.loop import UserData as JaxUserData
from consensus_entropy_tpu.config import ALConfig as JaxConfig
from consensus_entropy_tpu.data.audio import DeviceWaveformStore as JaxStore
from consensus_entropy_tpu.models.committee import CNNMember as JaxCNN
from consensus_entropy_tpu.models.committee import Committee as JaxCommittee
from consensus_entropy_tpu.models.committee import FramePool as JaxPool
from consensus_entropy_tpu.resilience import faults as jax_faults
from consensus_entropy_tpu_torch import convert
from consensus_entropy_tpu_torch.al import state as al_state
from consensus_entropy_tpu_torch.al import workspace
from consensus_entropy_tpu_torch.cli import fault_matrix as fm
from consensus_entropy_tpu_torch.resilience import faults
from tests import test_resilience as jax_res
from tests import test_torch_cnn_fleet as cf

torch.set_num_threads(1)

pytestmark = pytest.mark.faults


def _f1s(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for _, r in sorted({r["epoch"]: r for r in recs
                                  if "event" not in r}.items())]


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The port's unfaulted run, held against the JAX package's."""
    root = tmp_path_factory.mktemp("qbdc")
    user = cf._user(fm.QBDC["user_seed"])
    x, sids, labels, waves, host, cnn_vars = user
    cnn_cfg, train_cfg = fm.qbdc_configs()
    data, make_committee = fm.qbdc_user("cpu")
    # the port's draws are the CNN fleet tests' user
    np.testing.assert_array_equal(data.pool.X, JaxPool(x, sids).X)
    assert data.labels == labels
    ours = make_committee()
    for m, v in zip(ours.cnn_members, cnn_vars):
        ref = convert.cnn_variables_from_jax(v, cnn_cfg, "cpu")
        assert m.variables.keys() == ref.keys()
        for k in ref:
            assert torch.equal(m.variables[k], ref[k]), k
    jax_dir = root / "jax"
    jax_dir.mkdir()
    with jax_faults.inject() as jax_hits:
        JaxLoop(JaxConfig(queries=fm.QBDC["queries"], epochs=fm.QBDC["epochs"],
                          mode="qbdc", seed=fm.QBDC["seed"],
                          qbdc_k=fm.QBDC["qbdc_k"], ckpt_dtype="float32"),
                retrain_epochs=fm.QBDC["retrain_epochs"]).run_user(
            JaxCommittee(copy.deepcopy(host),
                         [JaxCNN(f"cnn.it_{j}", v, cf.JAX_TINY, cf.JAX_TC)
                          for j, v in enumerate(cnn_vars)], cf.JAX_TINY,
                         cf.JAX_TC),
            JaxUserData("q0", JaxPool(x, sids), labels,
                        store=JaxStore(waves, cnn_cfg.input_length)),
            str(jax_dir))
    port_dir = str(root / "port")
    with faults.inject() as hits:
        res = fm.qbdc_run(data, make_committee, port_dir, "cpu")
    # each point hit as often as in the JAX package (a vgg member's file
    # is one hit, .npz here and msgpack there)
    assert hits.hits == jax_hits.hits
    assert set(hits.hits) >= {p for p, _ in fm.QBDC_BOUNDARIES}
    theirs, mine = _f1s(str(jax_dir)), _f1s(port_dir)
    assert len(mine) == len(theirs) == fm.QBDC["epochs"] + 1
    for a, b in zip(mine, theirs):
        assert a.get("queried") == b.get("queried")
        assert a["f1"][2:] == b["f1"][2:]  # host members: tolerance 0
        np.testing.assert_allclose(a["f1"][:2], b["f1"][:2], atol=1e-6)
    return data, make_committee, res, al_state.ALState.load(port_dir).queried


def test_the_qbdc_rows_are_the_jax_packages_points():
    assert [p for p, _ in fm.QBDC_BOUNDARIES] == [
        p for p, _ in jax_res.QBDC_BOUNDARIES]


@pytest.mark.parametrize("point,at", fm.QBDC_BOUNDARIES,
                         ids=[p for p, _ in fm.QBDC_BOUNDARIES])
def test_qbdc_kill_at_every_boundary(baseline, tmp_path, point, at):
    data, make_committee, ref, queried = baseline
    cnn_cfg, train_cfg = fm.qbdc_configs()
    path = str(tmp_path / "faulted")
    out = fm.kill_and_resume(
        lambda p, committee=None: fm.qbdc_run(
            data, make_committee, p, "cpu", committee=committee),
        lambda p: workspace.load_committee(p, cnn_cfg, train_cfg,
                                           device="cpu"),
        point, at, path)
    if point == "checkpoint.write":
        # the deferred write of a vgg member's file (a host member's
        # carries its name)
        assert "member" not in out["fired"][0]
    assert al_state.ALState.load(path).queried == queried
    assert out["result"]["trajectory"] == ref["trajectory"]
