"""The port's static analysis against cetpu-lint, on the CPU.

The parsed contract tables equal the port's runtime ones; the twelve rule
ids are cetpu-lint's; every fire/silent snippet of ``tests/test_lint.py``
(and ``tests/test_gray.py``'s deadline cases) for the seven rules carried
over unchanged gives the same ``(rule, line, col)`` list through both
linters, each snippet placed at its package's counterpart path; the PRNG,
mask-update and host-sync rules give findings at the same lines on
translated twins (a ``jax.random`` snippet and its ``prng`` spelling), and
their torch idioms fire on their own; noqa, the baseline ratchet, the CLI
and the whole-tree gate (clean with an empty baseline, under 10 s, no
torch imported) hold as cetpu-lint's do."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from consensus_entropy_tpu.analysis import ProjectModel as JaxModel
from consensus_entropy_tpu.analysis import available_rules as jax_rules
from consensus_entropy_tpu.analysis import lint_source as jax_lint
from consensus_entropy_tpu_torch.analysis import (
    ProjectModel,
    available_rules,
    lint_paths,
    lint_source,
)
from consensus_entropy_tpu_torch.analysis.cli import (
    BASELINE_FILE,
    WALL_BUDGET_S,
    default_paths,
    main as lint_main,
)
from consensus_entropy_tpu_torch.analysis.engine import (
    apply_baseline,
    baseline_from,
    load_baseline,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = ProjectModel.from_repo(REPO)
JAX_MODEL = JaxModel.from_repo(REPO)
PORT, JAX = "consensus_entropy_tpu_torch/", "consensus_entropy_tpu/"


def fired(src, rel, *, select=None, package=PORT):
    """``[(rule, line, col)]`` of the port's linter on ``src`` placed at
    ``package + rel`` (``rel`` starting ``tests/`` is repo-relative)."""
    path = rel if rel.startswith("tests/") else package + rel
    return [(f.rule, f.line, f.col) for f in lint_source(
        textwrap.dedent(src), path, model=MODEL, select=select)]


def jax_fired(src, rel, *, select=None):
    path = rel if rel.startswith("tests/") else JAX + rel
    return [(f.rule, f.line, f.col) for f in jax_lint(
        textwrap.dedent(src), path, model=JAX_MODEL, select=select)]


# -- the model loader vs the runtime registries ------------------------------


def test_model_matches_runtime_registries():
    from consensus_entropy_tpu_torch.obs import export
    from consensus_entropy_tpu_torch.ops import scoring
    from consensus_entropy_tpu_torch.resilience import faults

    assert MODEL.fault_points == faults.FAULT_POINTS
    assert MODEL.event_fields == {k: dict(v) for k, v
                                  in export.EVENT_FIELDS.items()}
    assert all(kind in export.FIELD_KINDS
               for fields in MODEL.event_fields.values()
               for kind in fields.values())
    assert MODEL.fused_masks == {
        k: tuple(p for p in v if p is not None)
        for k, v in scoring.FUSED_MASKS.items()}
    # the positions are the ones the JAX package donates
    assert {k: set(v) for k, v in MODEL.fused_masks.items()} == \
        {k: set(v) for k, v in JAX_MODEL.fused_donate.items()}


def test_the_twelve_rule_ids_are_cetpu_lints():
    assert sorted(available_rules()) == sorted(jax_rules())
    assert len(available_rules()) == 12


# -- the seven rules carried over unchanged ---------------------------------

REPLAY, OPS, TESTS = "serve/fixture.py", "ops/fixture.py", \
    "tests/test_fixture.py"
WALL, SETS, FAULT, EVENT, DURABLE, LOCK, DEADLINE = (
    "replay-wallclock", "replay-set-iteration", "fault-point-literal",
    "event-schema", "raw-durable-io", "lock-discipline",
    "deadline-discipline")

#: (rule under test, place, snippet, how many findings of it)
SHARED = [
    (WALL, REPLAY, """
        import time

        def stamp():
            return time.time()
    """, 1),
    (WALL, OPS, """
        import time

        def stamp():
            return time.time()
    """, 0),
    (WALL, REPLAY, """
        import time

        class Watchdog:
            def __init__(self, deadline_s, *, clock=time.monotonic):
                self.clock = clock

            def expired(self, armed_t):
                return self.clock() - armed_t
    """, 0),
    (WALL, REPLAY, """
        import time

        def f(t=time.time()):
            return t
    """, 1),
    (WALL, REPLAY, """
        from datetime import datetime

        def stamp():
            return datetime.now()
    """, 1),
    (WALL, REPLAY, "import time\n\n\ndef f():\n    return time.time()"
     "  # cetpu: noqa[replay-wallclock] wall-stamp\n", 0),
    (WALL, REPLAY, "import time\n\n\ndef f():\n    return time.time()"
     "  # cetpu: noqa\n", 0),
    (WALL, REPLAY, "import time\n\n\ndef f():\n    return time.time()"
     "  # cetpu: noqa[event-schema] wrong rule\n", 1),
    (SETS, REPLAY, """
        def emit_all(xs, emit):
            for x in set(xs):
                emit(x)
    """, 1),
    (SETS, REPLAY, """
        class Server:
            def __init__(self):
                self.pending = set()

            def collect(self):
                return [x for x in self.pending]
    """, 1),
    (SETS, REPLAY, """
        def snapshot(live):
            return list({u for u in live})
    """, 1),
    (SETS, REPLAY, """
        class Server:
            def __init__(self):
                self.pending = set()

            def collect(self):
                return sorted(self.pending)

            def depth(self, width):
                return sum(1 for x in self.pending if x == width)
    """, 0),
    (SETS, REPLAY, """
        def derive():
            edges = set()
            edges.add(1)
            return tuple(sorted(edges))

        def restore(edges):
            return tuple(int(e) for e in edges)
    """, 0),
    (FAULT, OPS, """
        from consensus_entropy_tpu.resilience import faults

        def go():
            faults.fire("serve.dispatch", fn="mc", width=8)
    """, 0),
    (FAULT, OPS, """
        from consensus_entropy_tpu.resilience import faults

        def go():
            faults.fire("serve.dipatch")
    """, 1),
    (FAULT, OPS, """
        rule = FaultRule(point="nope", action="kill")
    """, 1),
    (FAULT, OPS, """
        class Plan:
            fault_point = "pool.score"
    """, 0),
    (FAULT, TESTS, """
        rules = parse_spec("checkpoint.write:kill@3,bogus.point:raise")
    """, 1),
    (EVENT, OPS, """
        def done(report, u):
            report.event("user_done", user=str(u))
    """, 0),
    (EVENT, OPS, """
        def admit(report, u):
            report.event("admit", user=str(u))
    """, 1),
    (EVENT, OPS, """
        def admit(report, u):
            report.event("totally_new_event", user=str(u))
    """, 1),
    (EVENT, OPS, """
        def fail(report, rec):
            report.event("user_failed", **rec)
    """, 0),
    (EVENT, OPS, """
        def emit(writer):
            writer.emit({"event": "enqueue", "user": "u1", "depth": 3,
                         "t_s": 0.1})
    """, 0),
    (EVENT, OPS, """
        def emit(writer):
            writer.emit({"event": "enqueue", "t_s": 0.1})
    """, 1),
    (EVENT, OPS, """
        def done(report):
            report.event("user_done", user=3)
    """, 1),
    (EVENT, OPS, """
        def enq(report):
            report.event("enqueue", user="u1", depth=True)
    """, 1),
    (EVENT, OPS, """
        def edges(report):
            report.event("planner_edges", edges="32,64")
    """, 1),
    (EVENT, OPS, """
        def edges(report, e):
            report.event("planner_edges", edges=[32, 64])
            report.event("planner_edges", edges=list(e))
    """, 0),
    (EVENT, OPS, """
        def emit(writer):
            writer.emit({"event": "enqueue", "user": "u1",
                         "depth": "3", "t_s": 0.1})
    """, 1),
    (DURABLE, REPLAY, """
        import os

        def persist(path, data):
            with open(path + ".tmp", "wb") as f:
                f.write(data)
                os.fsync(f.fileno())
            os.replace(path + ".tmp", path)
    """, 3),
    (DURABLE, REPLAY, """
        def log(path, line):
            with open(path, mode="a") as f:
                f.write(line)
    """, 1),
    (DURABLE, REPLAY, """
        def load(path):
            with open(path, "rb") as f:
                return f.read()

        def surgery(path):
            with open(path, "r+b") as f:  # the fault injector's corrupt
                f.write(b"x")
    """, 0),
    (DURABLE, OPS, """
        def dump(path, data):
            with open(path, "w") as f:
                f.write(data)
    """, 0),
    (DURABLE, REPLAY, """
        def lock_sibling(path):
            return open(path + ".lock", "ab")  # cetpu: noqa[raw-durable-io] zero-byte lock sibling
    """, 0),
    (LOCK, OPS, """
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def go(self):
                self._lock.acquire()
                try:
                    return 1
                finally:
                    self._lock.release()
    """, 1),
    (LOCK, OPS, """
        import threading

        _REG = threading.Lock()

        def go():
            _REG.acquire()
    """, 1),
    (LOCK, OPS, """
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def go(self):
                with self._lock:
                    return 1
    """, 0),
    (LOCK, OPS, """
        import threading

        class Q:
            def __init__(self):
                self._cond = threading.Condition()

            def go(self):
                self._cond.acquire()
    """, 0),
    (LOCK, OPS, """
        import threading

        class S:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.RLock()

            def go(self):
                with self._a:
                    with self._b:
                        return 1
    """, 1),
    (LOCK, OPS, """
        import threading

        class S:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def go(self):
                with self._a, self._b:
                    return 1
    """, 1),
    (LOCK, OPS, """
        import threading

        class S:
            def __init__(self):
                self._a = threading.Lock()

            def go(self, path):
                with self._a:
                    with open(path) as f:
                        return f.read()
    """, 0),
    (LOCK, OPS, """
        import threading

        class S:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def go(self):
                with self._a:
                    def cb():
                        with self._b:
                            return 1
                return cb
    """, 0),
    (DEADLINE, REPLAY, """
        def close(worker):
            worker.thread.join()
    """, 1),
    (DEADLINE, REPLAY, """
        def close(worker):
            worker.thread.join(timeout=2.0)
    """, 0),
    (DEADLINE, REPLAY, """
        import time

        def watch(path):
            while True:
                time.sleep(0.1)
    """, 1),
    (DEADLINE, REPLAY, """
        import time

        class W:
            def watch(self, deadline):
                while True:
                    if self._clock() > deadline:
                        break
                    time.sleep(0.1)
    """, 0),
    (DEADLINE, REPLAY, """
        import time

        def drain(q):
            while q:
                q.pop()
                time.sleep(0.01)
    """, 0),
    (DEADLINE, OPS, """
        def close(worker):
            worker.thread.join()
    """, 0),
]


@pytest.mark.parametrize("rule, rel, src, n", SHARED,
                         ids=[f"{r}-{i}" for i, (r, *_) in
                              enumerate(SHARED)])
def test_carried_over_rule_matches_cetpu_lint(rule, rel, src, n):
    ours = fired(src, rel, select=[rule])
    assert ours == jax_fired(src, rel, select=[rule])
    assert [r for r, _, _ in ours] == [rule] * n
    # every rule at once: the same list from both linters too
    assert fired(src, rel) == jax_fired(src, rel)


# -- the translated rules: twins at the same lines ---------------------------

SCHED, SERVER, ACQ = ("fleet/scheduler.py", "serve/server.py",
                      "al/acquisition.py")
PRNG_IMPORT = "from consensus_entropy_tpu_torch import prng"

#: (place, JAX snippet, the port's spelling as (old, new) replacements,
#: the rules fired)
TWINS = [
    (OPS, """
        def step(fns, probs, mask):
            res = fns["mc_fused"](probs, mask)
            return res, mask.sum()
    """, (), ["donation-after-use"]),
    (OPS, """
        def step(fns, probs, mask):
            res = fns["mc_fused"](probs, mask)
            mask = res.pool_mask
            return res, mask.sum()
    """, (), []),
    (OPS, """
        def step(fns, probs, mask):
            m = mask
            res = fns["mc_fused"](probs, m)
            return res, mask.sum()
    """, (), ["donation-after-use"]),
    (OPS, """
        def step(fns, probs, mask):
            m = mask
            res = fns["mc_fused"](probs, mask)
            return res, m.sum()
    """, (), ["donation-after-use"]),
    (OPS, """
        def step(fns, probs, mask):
            m = mask
            res = fns["mc_fused"](probs, m)
            m = res.pool_mask
            return res, m.sum()
    """, (), []),
    (OPS, """
        def step(fns, probs, mask):
            m = mask
            res = fns["mc_fused"](probs, mask)
            mask = res.pool_mask
            return res, m.sum()
    """, (), ["donation-after-use"]),
    (OPS, """
        def step(fns, probs, mask):
            m = mask
            res = fns["mc_fused"](probs, mask)
            mask = res.pool_mask
            return res, mask.sum()
    """, (), []),
    (OPS, """
        import jax

        key = jax.random.key(0)
    """, (("import jax", PRNG_IMPORT), ("jax.random.key", "prng.key")),
     ["prng-literal-key"]),
    (OPS, """
        import jax

        key = jax.random.PRNGKey(42)
    """, (("import jax", PRNG_IMPORT), ("jax.random.PRNGKey", "prng.key")),
     ["prng-literal-key"]),
    (TESTS, """
        import jax

        key = jax.random.key(0)
    """, (("import jax", PRNG_IMPORT), ("jax.random.key", "prng.key")), []),
    (OPS, """
        import jax

        def make(seed):
            return jax.random.key(seed)
    """, (("import jax", PRNG_IMPORT), ("jax.random.key", "prng.key")), []),
    (OPS, """
        import jax

        def draw(key):
            a = jax.random.uniform(key, (3,))
            b = jax.random.normal(key, (3,))
            return a, b
    """, (("import jax", PRNG_IMPORT), ("jax.random.normal(key, (3,))",
                                        "prng.bernoulli(key, 0.5, (3,))"),
          ("jax.random.", "prng.")), ["prng-key-reuse"]),
    (OPS, """
        import jax

        def draw(key):
            key, sub = jax.random.split(key)
            a = jax.random.uniform(sub, (3,))
            key, sub = jax.random.split(key)
            b = jax.random.normal(sub, (3,))
            return a, b
    """, (("import jax", PRNG_IMPORT), ("jax.random.normal(sub, (3,))",
                                        "prng.permutation(sub, 3)"),
          ("jax.random.", "prng.")), []),
    (OPS, """
        import jax

        def draw(key, flip):
            if flip:
                return jax.random.uniform(key, (3,))
            return jax.random.normal(key, (3,))
    """, (("import jax", PRNG_IMPORT), ("jax.random.normal(key, (3,))",
                                        "prng.random_bits(key, (3,))"),
          ("jax.random.", "prng.")), []),
    (OPS, """
        import jax

        def draw(key, n):
            out = []
            for i in range(n):
                out.append(jax.random.uniform(key, (3,)))
            return out
    """, (("import jax", PRNG_IMPORT), ("jax.random.", "prng.")),
     ["prng-key-reuse"]),
    (OPS, """
        import jax

        def draw(key, n):
            out = []
            for i in range(n):
                out.append(jax.random.uniform(
                    jax.random.fold_in(key, i), (3,)))
            return out
    """, (("import jax", PRNG_IMPORT), ("jax.random.", "prng.")), []),
    (SCHED, """
        import numpy as np

        class S:
            def _stacked_call(self, fn, vals):
                out = fn(vals)
                return float(out[0]), np.asarray(out[1]), out[2].item()

            def summary(self, out):
                return float(out[0])
    """, (), ["implicit-host-sync"] * 3),
    (SERVER, """
        import numpy as np

        class S:
            def _collect(self, rows):
                return np.asarray(rows[0])
    """, (), ["implicit-host-sync"]),
    (ACQ, """
        from consensus_entropy_tpu.ops import scoring

        class A:
            def _ids(self, res):
                idx = scoring.selection_scalars(res.indices)
                ok = scoring.selection_scalars(res.values) > 0
                return idx, ok
    """, (("consensus_entropy_tpu.", "consensus_entropy_tpu_torch."),), []),
    (ACQ, """
        from consensus_entropy_tpu.ops.scoring import selection_scalars

        class A:
            def finish_select(self, res):
                return selection_scalars(res.indices)
    """, (("consensus_entropy_tpu.", "consensus_entropy_tpu_torch."),), []),
    (ACQ, """
        import numpy as np

        class A:
            def finish_select(self, res):
                return float(res.values[0])
    """, (), ["implicit-host-sync"]),
]


@pytest.mark.parametrize("rel, src, twin, rules", TWINS,
                         ids=[f"twin-{i}" for i in range(len(TWINS))])
def test_translated_rule_finds_the_same_lines(rel, src, twin, rules):
    port_src = src
    for old, new in twin:
        port_src = port_src.replace(old, new)
    theirs = jax_fired(src, rel)
    ours = fired(port_src, rel)
    assert [r for r, _, _ in theirs] == rules
    assert [(r, line) for r, line, _ in ours] == \
        [(r, line) for r, line, _ in theirs]


# -- the torch idioms ---------------------------------------------------------


@pytest.mark.parametrize("call", ["rows.tolist()", "rows.cpu()",
                                  "rows.numpy()", 'rows.to("cpu")',
                                  'rows.to(device="cpu")',
                                  'rows.to(torch.device("cpu"))',
                                  "int(rows[0])",
                                  "torch.cuda.synchronize()"])
def test_host_sync_torch_idioms_fire_in_hot_functions_only(call):
    src = f"""
        import torch

        class S:
            def _stacked_call(self, fn, rows):
                return {call}

            def summary(self, rows):
                return {call}
    """
    assert fired(src, SCHED) == [("implicit-host-sync", 6, 15)]
    # a device-side move is no pull, and a literal int no tensor
    assert fired("""
        class S:
            def _stacked_call(self, fn, rows):
                return rows.to("cuda"), int(3), rows.cuda()
    """, SCHED) == []


def test_unseeded_torch_rng_in_replay_modules():
    for sampler in ("rand(3)", "randn(3)", "randint(0, 5, (3,))",
                    "randperm(5)", "bernoulli(p)", "multinomial(p, 2)",
                    "normal(0.0, 1.0, (3,))"):
        src = f"""
            import torch

            def jitter(p):
                return torch.{sampler}
        """
        assert fired(src, REPLAY) == [("replay-unseeded-rng", 5, 11)]
        assert fired(src, OPS) == []  # not a replay-critical module
        seeded = src.replace(")\n", ", generator=g)\n").replace(
            "(p)", "(p, g)")
        assert fired(seeded, REPLAY) == []
    # a generator nobody seeds is the global state by another name
    assert [r for r, _, _ in fired("""
        import torch

        def jitter():
            g = torch.Generator()
            return torch.rand(3, generator=g)
    """, REPLAY)] == ["replay-unseeded-rng"]
    assert fired("""
        import torch

        class Backoff:
            def __init__(self, seed):
                self.g = torch.Generator()
                self.g.manual_seed(seed)

            def jitter(self):
                return torch.rand(3, generator=self.g)

        def draw(seed):
            return torch.rand(3, generator=torch.Generator().manual_seed(
                seed))
    """, REPLAY) == []


def test_prng_and_generator_literal_seeds():
    assert [r for r, _, _ in fired("""
        import torch

        g = torch.Generator().manual_seed(0)
        torch.manual_seed(7)
    """, OPS)] == ["prng-literal-key"] * 2
    # the port's loop form: each iteration draws under its own key (the
    # JAX rule clears the loop target once, so it flags this shape)
    src = """
        def masks(keys, p):
            return [prng.bernoulli(key, p, (8,)) for key in keys]

        def loop(keys, p):
            out = []
            for key in keys:
                out.append(prng.bernoulli(key, p, (8,)))
            return out
    """
    assert fired(src, OPS) == []
    assert [r for r, _, _ in jax_fired(src.replace("prng.", "jax.random."),
                                       OPS)] == ["prng-key-reuse"]
    # the same key twice in the loop body still flags
    assert [r for r, _, _ in fired("""
        def loop(keys, p):
            for key in keys:
                a = prng.bernoulli(key, p, (8,))
                b = prng.uniform(key, (8,))
    """, OPS)] == ["prng-key-reuse"]


@pytest.mark.parametrize("fn, args, read, n", [
    ("hc_pre_fused", "ent, hc_mask, pool_mask", "pool_mask", 1),
    ("hc_pre_fused", "ent, hc_mask, pool_mask", "hc_mask", 1),
    ("mix_fused", "probs, pool_mask, freq, hc_mask", "hc_mask", 1),
    ("mix_fused", "probs, pool_mask, freq, hc_mask", "freq", 0),
    ("rand_fused", "key, pool_mask", "key", 0),
    ("rand_fused", "key, pool_mask", "pool_mask", 1),
])
def test_mask_operands_read_after_a_fused_step(fn, args, read, n):
    src = f"""
        def step(fns, {args}):
            res = fns["{fn}"]({args})
            return res, {read}.sum()
    """
    assert [r for r, _, _ in fired(src, OPS)] == ["donation-after-use"] * n
    # adopting the returned mask is the valid continuation
    assert fired(src.replace("            return",
                             f"            {read} = res.pool_mask\n"
                             "            return"), OPS) == []


# -- suppression and baseline ------------------------------------------------


def test_baseline_counts_grandfather_then_ratchet(tmp_path):
    src = textwrap.dedent("""
        import time

        def f():
            return time.time()

        def g():
            return time.time()
    """)
    path = PORT + REPLAY
    findings = lint_source(src, path, model=MODEL)
    assert [f.rule for f in findings] == ["replay-wallclock"] * 2
    baseline = baseline_from(findings)
    assert baseline == {"replay-wallclock:" + path: 2}
    assert apply_baseline(findings, baseline) == []
    left = apply_baseline(findings, {"replay-wallclock:" + path: 1})
    assert [f.line for f in left] == [findings[1].line]
    f = tmp_path / "lint_baseline.json"
    f.write_text(json.dumps({"replay-wallclock:x.py": 2}))
    assert load_baseline(str(f)) == {"replay-wallclock:x.py": 2}
    assert load_baseline(str(tmp_path / "missing.json")) == {}


# -- the whole tree ----------------------------------------------------------


def test_port_tree_lints_clean_with_an_empty_baseline():
    assert load_baseline(os.path.join(REPO, BASELINE_FILE)) == {}
    paths = default_paths(REPO)
    assert "chip_smoke.py" in paths and "tests/test_torch_lint.py" in paths
    result = lint_paths(paths, root=REPO, model=MODEL)
    assert result.errors == []
    assert result.findings == [], "\n".join(map(str, result.findings))
    assert result.files > 150
    assert result.suppressed >= 29  # the triaged sites, each justified
    assert result.wall_s < WALL_BUDGET_S == 10.0


def test_module_entry_point_imports_no_torch(tmp_path):
    code = ("import json, sys\n"
            "from consensus_entropy_tpu_torch.analysis.cli import main\n"
            "rc = main(['--format', 'json'])\n"
            "print(json.dumps({'rc': rc, 'torch': 'torch' in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    report, tail = out.stdout.strip().splitlines()
    assert json.loads(tail) == {"rc": 0, "torch": False}
    assert json.loads(report)["findings"] == []


def test_cli_end_to_end(tmp_path, capsys):
    """The entry point against a synthetic root: a violating file exits
    1 with a JSON finding; --write-baseline grandfathers it (exit 0);
    --list-rules prints the registry; usage errors exit 2."""
    pkg = tmp_path / "consensus_entropy_tpu_torch"
    for rel, payload in (
            ("resilience/faults.py",
             'FAULT_POINTS = frozenset({"pool.score"})'),
            ("obs/export.py",
             'EVENT_FIELDS = {"enqueue": {"user": "str", "depth": "int"}}'),
            ("ops/scoring.py",
             'FUSED_MASKS = {"mc_fused": (1, None)}')):
        f = pkg / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(payload + "\n")
    (pkg / "analysis").mkdir()
    bad = pkg / "serve" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import time\n\n\ndef f():\n    return time.time()\n")
    root = ["--root", str(tmp_path)]

    assert lint_main(root + ["--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert [(f["rule"], f["path"]) for f in payload["findings"]] == \
        [("replay-wallclock", "consensus_entropy_tpu_torch/serve/bad.py")]
    assert lint_main(root + ["--write-baseline"]) == 0
    capsys.readouterr()
    baseline = tmp_path / BASELINE_FILE
    assert json.loads(baseline.read_text()) == {
        "replay-wallclock:consensus_entropy_tpu_torch/serve/bad.py": 1}
    assert lint_main(root) == 0
    assert lint_main(root + ["--no-baseline"]) == 1
    capsys.readouterr()
    assert lint_main(["--list-rules"]) == 0
    assert "donation-after-use" in capsys.readouterr().out
    assert lint_main(root + ["--select", "no-such-rule"]) == 2
    assert lint_main(root + ["consensus_entropy_tpu_torch/srve"]) == 2
    # no baseline while a file does not parse
    (pkg / "serve" / "torn.py").write_text("def broken(:\n")
    before = baseline.read_text()
    assert lint_main(root + ["--write-baseline"]) == 2
    assert baseline.read_text() == before
