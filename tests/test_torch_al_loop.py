"""The port's AL loop against the JAX package's ``ALLoop`` on the CPU.

The same synthetic user and the same converted committee (GaussianNB and
SGD members fitted by scikit-learn, carried across by
``convert.host_members_from_jax``) go through both loops in every mode the
port runs, with the members scored on the host and on the device slice:
per iteration the queried songs are equal and the per-member F1s equal
exactly (tolerance 0: the members train and predict bit for bit alike, and
the selection's entropies agree within the repo's gate).  A run killed at
the state commit resumes to the uninterrupted end state, and a JAX
workspace left after iteration 2 resumes in the port to the JAX run's
final ``metrics.jsonl``."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.al.loop import ALLoop as JaxLoop
from consensus_entropy_tpu.al.loop import UserData as JaxUserData
from consensus_entropy_tpu.config import ALConfig as JaxConfig
from consensus_entropy_tpu.models.committee import Committee as JaxCommittee
from consensus_entropy_tpu.models.committee import FramePool as JaxPool
from consensus_entropy_tpu.models.sklearn_members import GNBMember as JaxGNB
from consensus_entropy_tpu.models.sklearn_members import SGDMember as JaxSGD
from consensus_entropy_tpu_torch import convert
from consensus_entropy_tpu_torch.al import workspace
from consensus_entropy_tpu_torch.al.loop import ALLoop, UserData
from consensus_entropy_tpu_torch.config import ALConfig
from consensus_entropy_tpu_torch.models.committee import Committee, FramePool
from consensus_entropy_tpu_torch.resilience import faults

torch.set_num_threads(1)

MODES = ["mc", "hc", "mix", "rand", "wmc"]
EPOCHS, Q, SEED = 3, 4, 11


@pytest.fixture(scope="module")
def user():
    """A 40-song user (F=8, 3-7 frames a song), its hc rows, and four
    members deliberately under-trained on one song per class."""
    rng = np.random.default_rng(1987)
    centers = rng.standard_normal((4, 8)).astype(np.float32) * 2.5
    rows, sids, labels = [], [], {}
    for i in range(40):
        sid, c = 200 + i, int(rng.integers(0, 4))
        labels[sid] = c
        k = int(rng.integers(3, 8))
        rows.append(centers[c] + rng.standard_normal((k, 8)).astype(
            np.float32))
        sids += [sid] * k
    x = np.vstack(rows)
    counts = rng.integers(1, 30, size=(40, 4))
    hc = np.round(counts / counts.sum(1, keepdims=True), 3).astype(
        np.float32)
    fit_x, fit_y = [], []
    for c in range(4):
        s = next(s for s, lab in labels.items() if lab == c)
        r = x[np.asarray(sids) == s]
        fit_x.append(r + rng.standard_normal(r.shape).astype(np.float32) * 3)
        fit_y += [c] * len(r)
    fit_x, fit_y = np.vstack(fit_x), np.asarray(fit_y)
    # in member-file order, the order a workspace loads them in
    members = [JaxGNB("gnb.it_0").fit(fit_x, fit_y),
               JaxGNB("gnb.it_1").fit(fit_x[::-1], fit_y[::-1]),
               JaxSGD("sgd.it_0", seed=0).fit(fit_x, fit_y),
               JaxSGD("sgd.it_1", seed=5).fit(fit_x, fit_y)]
    return x, sids, labels, hc, members


def _jax_run(user, path, mode, *, epochs=EPOCHS, device_members=False,
             committee=None, gate=False, fuse_step=True):
    x, sids, labels, hc, members = user
    com = committee or JaxCommittee(copy.deepcopy(members), [],
                                    device_members=device_members)
    data = JaxUserData("u0", JaxPool(x, sids), labels, hc_rows=hc)
    os.makedirs(path, exist_ok=True)
    return JaxLoop(JaxConfig(queries=Q, epochs=epochs, mode=mode, seed=SEED,
                             gate_host_updates=gate),
                   fuse_step=fuse_step).run_user(com, data, path)


def _port_run(user, path, mode, *, epochs=EPOCHS, device_members=False,
              committee=None, gate=False, fuse_step=True):
    x, sids, labels, hc, members = user
    com = committee or Committee(
        convert.host_members_from_jax(copy.deepcopy(members)),
        device_members=device_members, device="cpu")
    data = UserData("u0", FramePool(x, sids), labels, hc_rows=hc)
    os.makedirs(path, exist_ok=True)
    return ALLoop(ALConfig(queries=Q, epochs=epochs, mode=mode, seed=SEED,
                           gate_host_updates=gate),
                  fuse_step=fuse_step, device="cpu").run_user(com, data,
                                                              path)


def _metrics(path):
    """``metrics.jsonl``, the last record of each epoch."""
    with open(os.path.join(path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for _, r in sorted({r["epoch"]: r for r in recs
                                  if "event" not in r}.items())]


def _state(path):
    with open(os.path.join(path, "al_state.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("device_members", [False, True],
                         ids=["host", "device"])
@pytest.mark.parametrize("mode", MODES)
def test_loop_matches_jax(user, tmp_path, mode, device_members):
    jax_res = _jax_run(user, str(tmp_path / "jax"), mode,
                       device_members=device_members)
    res = _port_run(user, str(tmp_path / "port"), mode,
                    device_members=device_members)
    ours, theirs = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert len(ours) == len(theirs) == EPOCHS + 1
    for a, b in zip(ours, theirs):
        assert a.get("queried") == b.get("queried"), a["epoch"]
        assert a["f1"] == b["f1"], a["epoch"]  # tolerance 0
        assert a.get("pool_size") == b.get("pool_size")
    assert res["trajectory"] == jax_res["trajectory"]
    # the state (split, batches, key words, wmc weights) is the same file
    assert _state(tmp_path / "port") == _state(tmp_path / "jax")


def test_gated_unfused_loop_matches_jax(user, tmp_path):
    """The validation-gated update and the unfused select, as in JAX."""
    _jax_run(user, str(tmp_path / "jax"), "mix", gate=True, fuse_step=False)
    _port_run(user, str(tmp_path / "port"), "mix", gate=True,
              fuse_step=False)
    assert _metrics(tmp_path / "port") == _metrics(tmp_path / "jax")
    assert _state(tmp_path / "port") == _state(tmp_path / "jax")


def test_killed_run_resumes_to_the_uninterrupted_state(user, tmp_path):
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    _port_run(user, full, "mc")
    with faults.inject(faults.FaultRule("state.save", "kill", at=3)), \
            pytest.raises(faults.InjectedKill):
        _port_run(user, part, "mc")  # dies committing iteration 2's state
    assert any(n.startswith("_staged_gen") for n in os.listdir(part))
    com = workspace.load_committee(part)  # the torn stage is discarded
    assert _state(part)["next_epoch"] == 1
    _port_run(user, part, "mc", committee=com)
    assert _metrics(part) == _metrics(full)
    assert _state(part) == _state(full)
    for f in os.listdir(full):
        if f.endswith(".npz"):
            with open(os.path.join(full, f), "rb") as a, \
                    open(os.path.join(part, f), "rb") as b:
                assert a.read() == b.read()


def test_jax_workspace_resumes_in_the_port(user, tmp_path):
    """JAX runs 2 iterations and persists; the port converts the workspace
    and finishes the run: the JAX uninterrupted run's metrics."""
    full = str(tmp_path / "full")
    _jax_run(user, full, "wmc", epochs=4)
    src, dst = str(tmp_path / "jax"), str(tmp_path / "port")
    com = JaxCommittee(copy.deepcopy(user[4]), [])
    _jax_run(user, src, "wmc", epochs=2, committee=com)
    com.save(src)  # the CLI saves the members when the run ends
    copied = convert.workspace_from_jax(src, dst)
    assert "al_state.json" in copied and any(n.endswith(".npz")
                                             for n in copied)
    assert _state(dst)["next_epoch"] == 2
    _port_run(user, dst, "wmc", epochs=4,
              committee=workspace.load_committee(dst))
    assert _metrics(dst) == _metrics(full)
    assert _state(dst) == _state(full)


def test_corrupt_member_file_rolls_back_one_generation(user, tmp_path):
    """A member file corrupted at the last commit (bit-rot the atomic
    renames cannot prevent) rolls the workspace back to the previous
    generation; the resumed run replays that iteration to the same end."""
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    _port_run(user, full, "rand")
    n_files = len(user[4])
    # the last commit's first member file: writes (EPOCHS) * n_files + 1
    with faults.inject(faults.FaultRule("checkpoint.write", "corrupt",
                                        at=EPOCHS * n_files + 1)):
        _port_run(user, part, "rand")
    with pytest.warns(UserWarning, match="rolled back"):
        com = workspace.load_committee(part)
    assert _state(part)["next_epoch"] == EPOCHS - 1
    _port_run(user, part, "rand", committee=com)
    assert _metrics(part) == _metrics(full)
    assert _state(part) == _state(full)
