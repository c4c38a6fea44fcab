"""What pins the port's fault points, on the CPU.

- Every name in the port's ``FAULT_POINTS`` (the JAX package's set) is
  fired by at least one row of a port test, ``chip_smoke.py`` or
  ``cli/fault_matrix.py``: it is the point of a ``FaultRule(...)`` call,
  the ``point`` of a ``pytest.mark.parametrize`` row (the values the
  decorator holds, read from the imported module), the point of a
  ``kill_at=`` coordinator kill, or a point of a spec given to
  ``CETPU_FAULTS``.  A point named anywhere else (a table, a message, a
  comparison, prose) does not count.  A point added later without a row
  fails here.
- One unfaulted run hits each point as often in the port as in the JAX
  package, mode by mode: the host-member session of the kill matrix in
  the five host modes with its members scored on the device (on the host
  in ``test_torch_fault_matrix.py``) and a served cohort.  The kill
  matrix's hit numbers mean the same boundary in both.  (The qbdc counts
  are held in ``test_torch_fault_matrix_qbdc.py``; there is no
  storage-format difference: a member file is one hit in
  both, ``.npz`` here and a pickle or msgpack there.)
- The fabric workload's two-bucket users (``sizes=``) are the JAX
  workload's."""

import ast
import copy
import glob
import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.fleet import FleetReport as JaxReport
from consensus_entropy_tpu.fleet import FleetScheduler as JaxScheduler
from consensus_entropy_tpu.fleet import FleetUser as JaxUser
from consensus_entropy_tpu.models.committee import Committee as JaxCommittee
from consensus_entropy_tpu.resilience import faults as jax_faults
from consensus_entropy_tpu.serve import AdmissionJournal as JaxJournal
from consensus_entropy_tpu.serve import FleetServer as JaxServer
from consensus_entropy_tpu.serve import ServeConfig as JaxServeConfig
from consensus_entropy_tpu_torch import convert
from consensus_entropy_tpu_torch.cli import fault_matrix as fm
from consensus_entropy_tpu_torch.models.committee import Committee
from consensus_entropy_tpu_torch.resilience import faults
from tests import fabric_workload as jax_workload
from tests import test_fleet as jax_fleet
from tests import test_resilience as jax_res
from tests import test_torch_fault_matrix as tfm
from tests import torch_fabric_workload as workload

torch.set_num_threads(1)

pytestmark = pytest.mark.faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: keywords whose value is a point the row kills at, or a fault spec
FIRING_KEYWORDS = ("kill_at", "CETPU_FAULTS")


def _scanned():
    files = sorted(glob.glob(os.path.join(REPO, "tests", "test_torch_*.py"))
                   + glob.glob(os.path.join(REPO, "tests", "torch_*.py")))
    # this file names every point in its own checks
    files.remove(os.path.abspath(__file__))
    return files + [os.path.join(REPO, "chip_smoke.py"),
                    os.path.join(REPO, "consensus_entropy_tpu_torch", "cli",
                                 "fault_matrix.py")]


def _points(node):
    """The points a literal names: a point, or each ``point:action`` of a
    spec (an f-string's leading text)."""
    if isinstance(node, ast.JoinedStr):
        node = node.values[0] if node.values else None
    if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
        return set()
    return {part.strip().split(":", 1)[0]
            for part in node.value.split(",")} & faults.FAULT_POINTS


def _is_name(node, name):
    return isinstance(node, ast.Constant) and node.value == name


def _module(path):
    """``path`` imported: a test module under its package name."""
    tests = os.path.join(REPO, "tests")
    if os.path.dirname(os.path.abspath(path)) == tests:
        return importlib.import_module(
            "tests." + os.path.basename(path)[:-len(".py")])
    spec = importlib.util.spec_from_file_location("_scanned_rows", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parametrized_points(path, funcs):
    """The ``point`` values of the parametrize rows of ``funcs`` (names
    of ``path``'s test functions), as the decorators hold them."""
    mod, out = _module(path), set()
    for name in funcs:
        for mark in getattr(getattr(mod, name), "pytestmark", ()):
            if mark.name != "parametrize":
                continue
            names = mark.args[0]
            names = ([n.strip() for n in names.split(",")]
                     if isinstance(names, str) else list(names))
            if "point" not in names:
                continue
            at = names.index("point")
            for row in mark.args[1]:
                values = getattr(row, "values", row)
                if len(names) == 1:
                    values = (values,)
                out.add(values[at])
    return out & faults.FAULT_POINTS


def _fired_by(path):
    """The fault points a row of ``path`` fires (see the module doc)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out, funcs = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) \
                else getattr(func, "id", None)
            if name == "FaultRule":
                point = node.args[0] if node.args else next(
                    (k.value for k in node.keywords if k.arg == "point"),
                    None)
                out |= _points(point)
            out |= {p for k in node.keywords if k.arg in FIRING_KEYWORDS
                    for p in _points(k.value)}
        elif isinstance(node, ast.Assign):
            # env["CETPU_FAULTS"] = spec
            out |= {p for t in node.targets if isinstance(t, ast.Subscript)
                    and _is_name(t.slice, "CETPU_FAULTS")
                    for p in _points(node.value)}
        elif isinstance(node, ast.Dict):
            out |= {p for k, v in zip(node.keys, node.values)
                    if _is_name(k, "CETPU_FAULTS") for p in _points(v)}
        elif isinstance(node, ast.FunctionDef) and any(
                isinstance(d, ast.Call) and isinstance(d.func, ast.Attribute)
                and d.func.attr == "parametrize" and d.args
                and isinstance(d.args[0], ast.Constant)
                and "point" in str(d.args[0].value).replace(" ", "")
                .split(",") for d in node.decorator_list):
            funcs.append(node.name)
    if funcs:
        out |= _parametrized_points(path, funcs)
    return out


def test_every_fault_point_is_fired_by_a_row():
    assert faults.FAULT_POINTS == jax_faults.FAULT_POINTS
    assert len(faults.FAULT_POINTS) == 27
    by = {}
    for path in _scanned():
        for point in _fired_by(path):
            by.setdefault(point, []).append(os.path.relpath(path, REPO))
    missing = sorted(faults.FAULT_POINTS - set(by))
    assert missing == [], f"fault points no row fires: {missing}"


def test_the_scan_sees_a_row_and_not_a_docstring(tmp_path):
    path = tmp_path / "rows.py"
    path.write_text(
        '"""io.rename named in prose"""\n'
        'import pytest\n'
        'from consensus_entropy_tpu_torch.resilience.faults import '
        'FaultRule\n'
        'RULE = FaultRule("fabric.lease", "kill")\n'
        'ENV = {"CETPU_FAULTS": "io.fsync:raise@2,serve.admit:kill"}\n'
        'TABLE = [("fabric.drain", 1), "member.retrain:kill"]\n'
        '@pytest.mark.parametrize("mode,point", [("mc", "pool.score")])\n'
        'def test_row(mode, point):\n'
        '    assert point != "fabric.spawn", f"fabric.gray {point}"\n')
    assert _fired_by(str(path)) == {"fabric.lease", "io.fsync",
                                    "serve.admit", "pool.score"}


@pytest.mark.parametrize("mode", ["mc", "hc", "mix", "rand", "wmc"])
def test_an_unfaulted_session_hits_each_point_as_jax(tmp_path, mode):
    """Members scored on the device (``test_torch_fault_matrix.py`` holds
    the host-member runs it makes for its rows)."""
    data = jax_res._make_user(np.random.default_rng(
        fm.SESSION["user_seed"]))
    members = jax_res._committee(np.random.default_rng(0), data).host_members
    (tmp_path / "jax").mkdir()
    with jax_faults.inject() as theirs:
        jax_res._run(data, tmp_path / "jax", mode=mode,
                     committee=JaxCommittee(copy.deepcopy(members), [],
                                            device_members=True))
    with faults.inject() as ours:
        fm.session_run(fm.session_user(), str(tmp_path / "port"), mode,
                       "cpu", committee=Committee(
                           convert.host_members_from_jax(members),
                           device_members=True, device="cpu"))
    assert ours.hits == theirs.hits
    # scored on the device, the members fire no member.predict, in both
    assert "member.predict" not in ours.hits


#: the served cohort's points that fire once a round of the serve loop,
#: with the context key that counts the round's users: how many users a
#: round takes (finished at once, or scored in one stacked dispatch) is up
#: to the worker threads' timing, in both packages
ROUNDS = {"serve.collect": "n", "serve.dispatch": "batch"}


def _watch(pkg_faults):
    """Rules that fire at every round point and do nothing, so that each
    hit's context lands in ``inj.fired``."""
    return [pkg_faults.FaultRule(p, "delay", times=-1, delay_s=0.0)
            for p in ROUNDS]


def _per_round(inj):
    """``({point: hits}`` but the round points, ``{round point: users
    over its rounds}``)."""
    users = {p: sum(f[k] for f in inj.fired if f["point"] == p)
             for p, k in ROUNDS.items()}
    return {p: n for p, n in inj.hits.items() if p not in ROUNDS}, users


def test_an_unfaulted_served_cohort_hits_each_point_as_jax(tmp_path):
    """The serve rows' three users through each package's server: every
    point is hit as often in both, and each round point's rounds carry as
    many users in both."""
    jax_entries = []
    for seed, uid, n in tfm.SERVE_USERS:
        jdata, members = tfm._serve_user(seed, uid, n)
        (tmp_path / f"jax_{uid}").mkdir()
        jax_entries.append(JaxUser(uid, JaxCommittee(members, []), jdata,
                                   str(tmp_path / f"jax_{uid}"), seed=7))
    jax_journal = JaxJournal(str(tmp_path / "jax_journal.jsonl"))
    with jax_faults.inject(*_watch(jax_faults)) as theirs:
        JaxServer(JaxScheduler(jax_fleet._cfg(mode="mc", epochs=2),
                               report=JaxReport(), scoring_by_width=True),
                  JaxServeConfig(target_live=2),
                  journal=jax_journal).serve(iter(jax_entries))
    jax_journal.close()
    journal = tfm.AdmissionJournal(str(tmp_path / "journal.jsonl"))
    with faults.inject(*_watch(faults)) as ours:
        tfm._server(tfm._serve_cfg("mc"), journal).serve(
            iter(tfm._entries(tmp_path)))
    journal.close()
    (hits, users), (jax_hits, jax_users) = _per_round(ours), \
        _per_round(theirs)
    assert hits == jax_hits
    assert users == jax_users
    assert users["serve.collect"] == len(tfm.SERVE_USERS)
    assert {"serve.admit", "serve.journal.append"} <= set(hits)
    assert all(ours.hits[p] >= 1 for p in ROUNDS)


def test_the_fabric_workloads_two_buckets_are_the_jax_workloads():
    specs = workload.user_specs(6, sizes=[30, 100])
    assert specs == jax_workload.user_specs(6, sizes=[30, 100])
    assert workload.sizes_arg(specs) == jax_workload.sizes_arg(specs) \
        == "30,100,30,100,30,100"
    assert workload.user_specs(3) == jax_workload.user_specs(3)
    seed, uid, n = specs[1]
    ours = workload.make_data(seed, uid, n_songs=n)
    theirs = jax_workload.make_data(seed, uid, n_songs=n)
    assert ours.pool.n_songs == theirs.pool.n_songs == 100
    np.testing.assert_array_equal(ours.pool.X, theirs.pool.X)
    assert ours.labels == theirs.labels
