"""The lint rules — one per load-bearing convention in the port.

Counterpart of ``consensus_entropy_tpu/analysis/rules.py``: the same
twelve rules under the same ids, every scoping table rooted at the port's
package.  Seven carry over unchanged in contract (``replay-wallclock``,
``replay-set-iteration``, ``fault-point-literal``, ``event-schema``,
``raw-durable-io``, ``lock-discipline``, ``deadline-discipline``); the
others read PyTorch's idioms where the JAX package has JAX's:
``replay-unseeded-rng`` also flags ``torch.rand*`` samplers without a
``generator=`` and unseeded ``torch.Generator`` objects; the PRNG rules
track the port's threefry module (``prng.key``/``split``/``uniform``/...);
``donation-after-use`` reads ``ops.scoring.FUSED_MASKS``; and
``implicit-host-sync`` adds ``.tolist()``/``.cpu()``/``.numpy()``/
``.to("cpu")``/``int()``/``torch.cuda.synchronize()``.

Each rule documents the CONTRACT it enforces, the scope it applies to,
and what the accepted escape hatch is (``# cetpu: noqa[rule] <why>``).
All checks are pure-AST heuristics: linear over branches where real
dataflow would need a solver, conservative where types are unknowable.
A false positive is one visible noqa with a justification — the price
of machine-checking conventions that otherwise only fail at 3am in a
replay drill.

Scoping tables (kept here, next to the rules that read them):

- :data:`REPLAY_PREFIXES` / :data:`REPLAY_FILES` — the replay-critical
  surface: everything journaled, checkpointed or replayed must be a
  pure function of journal/seed state, never of wall clock or unseeded
  RNG (serve journal replay, fleet eviction+resume, resilience
  recovery, ALState).
- :data:`HOT_PATH_FUNCS` — the scheduler's dispatch hot path, where the
  h2d/d2h accounting assumes every transfer goes through
  ``Acquirer.take_h2d`` and an implicit ``float()``/``.item()`` sync
  would both stall the pipeline and escape the accounting.
- :data:`LOCK_ORDER` — the documented lock-acquisition order table for
  the ``lock-discipline`` rule.  EMPTY by design: the stack's threading
  convention is single-lock critical sections (``with self._lock:``),
  never nested locks — a nested acquisition is a latent deadlock the
  moment a second code path takes the pair in the other order.  Adding
  a pair here is the sanctioned way to introduce an ordering (and the
  review surface for it).
"""

from __future__ import annotations

import ast
import functools

from consensus_entropy_tpu_torch.analysis.engine import register

PKG = "consensus_entropy_tpu_torch/"

#: replay-critical modules (directory prefixes + exact files)
REPLAY_PREFIXES = (
    PKG + "serve/",
    PKG + "fleet/",
    PKG + "resilience/",
    PKG + "workload/",
)
REPLAY_FILES = (
    PKG + "al/state.py",
    PKG + "al/workspace.py",
)

#: dispatch hot paths: file -> function names whose whole subtree
#: (nested closures included) must not host-sync implicitly.  Beyond
#: the scheduler's dispatch core this now covers the serve loop's
#: per-round admission/collection paths and the acquirer's staging +
#: select-finish path — made possible by the one sanctioned pull below.
HOT_PATH_FUNCS = {
    PKG + "fleet/scheduler.py": {
        "pump", "_dispatch_scores", "_stacked_call", "_plan_call",
        "_single_call", "_result_rows", "_hold_partial_plans",
        "_h2d", "_stack", "_sig",
    },
    PKG + "serve/server.py": {
        "serve", "_refill", "_admit_up_to_target", "_collect",
        "_admit_due_requeues", "_apply_fences",
    },
    PKG + "al/acquisition.py": {
        "finish_select", "_ids", "scoring_inputs", "run_scoring",
        "take_h2d", "device_masks",
    },
    PKG + "acquire/builtin.py": {"extract_queries", "fused_inputs",
                                 "scoring_inputs"},
}

#: the ONE sanctioned hot-path device→host pull: the 2·k selection
#: scalars ``finish_select`` maps back to song ids each iteration
#: (``ops.scoring.selection_scalars``).  Spelled through a named helper
#: so the rule can whitelist the INTENT, not a line — any other
#: ``np.asarray``/``float()`` in a hot-path function stays a finding.
_SANCTIONED_PULLS = {"selection_scalars"}

#: wall-clock reads replay can never reproduce.  ``time.perf_counter``
#: is deliberately ABSENT: it is the stack's sanctioned duration-
#: telemetry clock (StepTimer, wait_s, span durations) — process-local
#: deltas that never feed a journaled decision; listing it would bury
#: the real signal under telemetry noqas.
_WALLCLOCKS = {
    "time.time", "time.monotonic", "time.time_ns", "time.monotonic_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.now", "datetime.utcnow",  # `from datetime import datetime`
}

#: ``prng`` fns (the port's threefry, ``prng.py``) that CONSUME the key
#: passed in first position (using the same key at a second sink yields
#: identical streams; ``split`` consumes too: the parent key must not
#: outlive it).  ``fold_in`` and ``fold_in_static`` derive a child and
#: leave the parent usable, as ``jax.random.fold_in`` does.
_KEY_CONSUMERS = {
    "split", "uniform", "uniform_rows", "random_bits", "bernoulli",
    "permutation", "truncated_normal",
}

#: torch samplers that draw from the global generator unless given a
#: ``generator=``
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "bernoulli",
                   "multinomial", "normal"}

#: order-independent consumers a set may feed directly
_ORDER_FREE = {"sorted", "sum", "min", "max", "any", "all", "len",
               "set", "frozenset"}

#: order-CAPTURING conversions of an iterable
_ORDER_CAPTURE = {"list", "tuple", "enumerate", "iter", "reversed"}

#: documented lock-acquisition order: ``(outer_path, inner_path)`` pairs
#: a nested ``with`` acquisition is allowed to take.  Empty — the stack
#: has no sanctioned nested-lock pair today (see the module docstring);
#: the coordinator/worker planes stay deadlock-free by construction
#: because every critical section holds exactly one lock.
LOCK_ORDER: tuple = ()


@functools.lru_cache(maxsize=1)
def _walk(tree) -> tuple:
    """Every node of ``tree`` in ``ast.walk`` order, computed once per
    file: every rule walks the module, and the engine runs the rules one
    file at a time."""
    return tuple(ast.walk(tree))


def _in_pkg(path: str) -> bool:
    return path.startswith(PKG)


def _in_replay_scope(path: str) -> bool:
    return path.startswith(REPLAY_PREFIXES) or path in REPLAY_FILES


def _dotted(node) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _iter_scopes(tree):
    """Yield ``(scope_node, body)`` for the module and every function —
    each analyzed independently (nested defs get their own scope AND
    appear, unanalyzed, in their parent's)."""
    yield tree, tree.body
    for node in _walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, node.body


def _calls_in_order(stmt):
    """Call nodes within one statement, source order (nested defs and
    lambdas excluded — separate control flow)."""
    skip: set[int] = set()
    for node in ast.walk(stmt):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not stmt:
            for sub in ast.walk(node):
                skip.add(id(sub))
    calls = [n for n in ast.walk(stmt)
             if isinstance(n, ast.Call) and id(n) not in skip]
    return sorted(calls, key=lambda n: (n.lineno, n.col_offset))


def _store_paths(stmt) -> list[str]:
    """Dotted paths assigned by this statement (tuple targets unpacked)."""
    targets = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.For):
        targets = [stmt.target]
    elif isinstance(stmt, ast.withitem) and stmt.optional_vars:
        targets = [stmt.optional_vars]
    out = []
    stack = list(targets)
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        else:
            path = _dotted(t)
            if path:
                out.append(path)
    return out


# -- rule 1: donation-after-use ---------------------------------------------


def _donated_positions(call, model) -> tuple | None:
    """Which positional args of ``call`` are mask operands a fused step
    updates in place, or None."""
    f = call.func
    if isinstance(f, ast.Subscript):  # fns["mc_fused"](...)
        sl = f.slice
        if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
            return model.fused_masks.get(sl.value)
        return None
    name = _dotted(f)
    if name is None:
        return None
    return model.fused_masks.get(name.split(".")[-1])


@register(
    "donation-after-use",
    doc="no read of a mask operand after it was passed to a *_fused "
        "step that updates it in place (ops.scoring.FUSED_MASKS)",
    applies=_in_pkg)
def check_donation_after_use(tree, ctx):
    """The fused serve step's contract: the ``*_fused`` steps update
    their mask operands in place (``ops.scoring.FUSED_MASKS``, the
    positions the JAX package's ``FUSED_DONATE`` donates), and the
    result's ``pool_mask``/``hc_mask`` is the one buffer the caller
    continues with.  A read of the operand after the call sees the
    shrunken mask where the code means the one it passed, or — when a
    stacked call worked on a copy — a row the scheduler has not yet
    copied back; either way the JAX package's version of the same line
    reads a spent buffer.  The only valid continuation is the RETURNED
    buffer (``finish_select`` adopts ``FusedStepResult`` masks).  Linear
    over branches — an update in one branch and a read in the other
    flags conservatively.

    The JAX rule also tracks module-level ``jax.jit(...,
    donate_argnums=...)`` wrappers; a torch function has no donation, so
    that half has no counterpart here.

    FLOW-SENSITIVE over local rebinds: a pure alias assignment
    (``m = mask`` / ``m = self.device.probs``) links the names, so
    passing EITHER spends both — a read through the other spelling
    still flags — while rebinding a name to the returned buffer (or
    anything else) breaks only ITS link.  Rebinding the alias TARGET
    carries the pending consumption onto the surviving alias: the old
    name's buffer is gone, but the alias still holds the spent one."""
    findings = []
    if not any(isinstance(n, ast.Call) and _donated_positions(n, ctx.model)
               for n in _walk(tree)):
        return findings  # no fused step in the file: nothing to track
    for _scope, body in _iter_scopes(tree):
        consumed: dict[str, int] = {}  # canonical path -> donating line
        aliases: dict[str, str] = {}   # name -> canonical dotted path

        def canon(path):
            """Resolve a path's leading name through the alias table
            (alias values are stored pre-canonicalized, so one hop)."""
            head, _, rest = path.partition(".")
            head = aliases.get(head, head)
            return head + ("." + rest) if rest else head

        def flat(node, store_paths=()):
            """Process one straight-line node: register donations, flag
            loads of already-donated paths, then clear stores and
            update the alias links the node's assignments create."""
            donated_args: set[int] = set()
            for call in _calls_in_order(node):
                pos = _donated_positions(call, ctx.model)
                if not pos:
                    continue
                for p in pos:
                    if p < len(call.args):
                        path = _dotted(call.args[p])
                        if path:
                            donated_args.add(id(call.args[p]))
                            consumed[canon(path)] = call.lineno
            if consumed:
                flagged: set[tuple] = set()  # one per (path, line)
                for sub in ast.walk(node):
                    if id(sub) in donated_args:
                        continue
                    if not isinstance(sub, (ast.Name, ast.Attribute)):
                        continue
                    if not isinstance(getattr(sub, "ctx", None),
                                      ast.Load):
                        continue
                    path = _dotted(sub)
                    if path is None:
                        continue
                    cpath0 = canon(path)
                    for cpath, at in consumed.items():
                        if cpath0 != cpath \
                                and not cpath0.startswith(cpath + "."):
                            continue
                        if (cpath, sub.lineno) in flagged:
                            continue  # mask and mask.sum are ONE read
                        flagged.add((cpath, sub.lineno))
                        label = repr(path) if cpath0 == path else \
                            f"{path!r} (an alias of {cpath!r})"
                        findings.append(ctx.finding(
                            "donation-after-use", sub,
                            f"{label} was passed to a fused step "
                            f"on line {at}, which updates it in "
                            "place, and is read here; use the "
                            "returned mask instead"))
            for spath in store_paths:
                aliases.pop(spath, None)  # the rebind breaks ITS link
                for a, v in list(aliases.items()):
                    if v != spath and not v.startswith(spath + "."):
                        continue
                    # the alias outlives its rebound target: it still
                    # references the OLD buffer, so a pending
                    # consumption survives under the alias's own name
                    at = consumed.get(v)
                    if at is not None:
                        consumed[a] = at
                    del aliases[a]
                for cpath in list(consumed):
                    if cpath == spath or cpath.startswith(spath + "."):
                        del consumed[cpath]
            # pure alias assigns (no call on the value side) link AFTER
            # the store cleared the target's previous state
            value = getattr(node, "value", None) \
                if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                else None
            vpath = _dotted(value) if value is not None else None
            if vpath:
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        cv = canon(vpath)
                        if cv != t.id:
                            aliases[t.id] = cv

        def scan(stmts):
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.ClassDef)):
                    continue
                if isinstance(stmt, ast.If):
                    flat(stmt.test)
                    scan(stmt.body)
                    scan(stmt.orelse)
                elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                    flat(stmt.iter, _store_paths(stmt))
                    scan(stmt.body)
                    scan(stmt.orelse)
                elif isinstance(stmt, ast.While):
                    flat(stmt.test)
                    scan(stmt.body)
                    scan(stmt.orelse)
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    for item in stmt.items:
                        flat(item.context_expr, _store_paths(item))
                    scan(stmt.body)
                elif isinstance(stmt, ast.Try):
                    scan(stmt.body)
                    for handler in stmt.handlers:
                        scan(handler.body)
                    scan(stmt.orelse)
                    scan(stmt.finalbody)
                else:
                    flat(stmt, _store_paths(stmt))

        scan(body)
    return findings


# -- rule 2a: literal PRNG seeds --------------------------------------------


@register(
    "prng-literal-key",
    doc="no prng.key / manual_seed with a literal seed in library "
        "code (derive from the run seed; tests/bench are exempt)",
    applies=_in_pkg)
def check_prng_literal(tree, ctx):
    """Replay, failover and the qbdc mask discipline all assume every
    key in the system derives from the ONE run seed (fold_in/split
    chains from ``ALConfig.seed``).  A literal ``prng.key(0)`` (or a
    torch generator's ``manual_seed(0)``) buried in library code
    silently decouples that stream: two users collide, or a resume
    replays a different committee than the original run."""
    findings = []
    for node in _walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "manual_seed":
            is_key_ctor = True  # torch.manual_seed, g.manual_seed, ...
        else:
            parts = (_dotted(node.func) or "").split(".")
            is_key_ctor = parts[-1] == "PRNGKey" or \
                parts[-2:] == ["prng", "key"]
        if not is_key_ctor:
            continue
        seed = node.args[0]
        if isinstance(seed, ast.Constant) \
                and isinstance(seed.value, (int, float)):
            findings.append(ctx.finding(
                "prng-literal-key", node,
                f"literal PRNG seed {seed.value!r} in library code; "
                "derive the key from the run seed (config/CLI) so "
                "replay and failover reproduce the stream"))
    return findings


# -- rule 2b: key reuse ------------------------------------------------------


def _key_consumer_operand(call):
    """``(path, fn)`` when ``call`` is a ``prng`` consumer taking a
    trackable key in first position, else None."""
    name = _dotted(call.func)
    if name is None or not call.args:
        return None
    parts = name.split(".")
    if len(parts) < 2 or parts[-2] != "prng" \
            or parts[-1] not in _KEY_CONSUMERS:
        return None
    path = _dotted(call.args[0])
    return (path, parts[-1]) if path else None


@register(
    "prng-key-reuse",
    doc="no key consumed by two prng sinks without an "
        "interleaving split/fold_in",
    applies=_in_pkg)
def check_prng_key_reuse(tree, ctx):
    """QBDC committees, dropout schedules and the rand acquisition mode
    are bit-replayable because every sink gets its OWN key: ``k, sub =
    split(k)`` before each use, or ``fold_in(k, i)`` per member.
    Feeding one key to two sinks yields identical (not independent)
    draws — a committee whose members agree by construction, an AL run
    whose "random" arm repeats its first batch.  ``If`` branches fork
    the tracking state and re-merge (union of consumed); loop bodies
    are scanned twice so loop-carried reuse is caught, a ``for``
    target cleared before each pass (the JAX rule clears it once, so
    ``for key in keys:`` with one sink a key flags there)."""
    findings = []
    if not any(isinstance(n, ast.Call) and _key_consumer_operand(n)
               for n in _walk(tree)):
        return findings  # no sink in the file: nothing to track

    def flag(call, path, fn, first):
        findings.append(ctx.finding(
            "prng-key-reuse", call,
            f"key {path!r} already consumed on line {first} is fed to "
            f"prng.{fn} again; split/fold_in between sinks"))

    def consume_calls(node, state, seen):
        for call in _calls_in_order(node):
            op = _key_consumer_operand(call)
            if op is None:
                continue
            path, fn = op
            if path in state:
                if id(call) not in seen:
                    seen.add(id(call))
                    flag(call, path, fn, state[path])
            else:
                state[path] = call.lineno

    def clear_stores(paths, state):
        for spath in paths:
            for kpath in list(state):
                if kpath == spath or kpath.startswith(spath + "."):
                    del state[kpath]

    def scan(stmts, state, seen) -> bool:
        """Scan a block; returns True when it TERMINATES (every path
        returns/raises), so an If whose taken branch exits never leaks
        its consumed keys into the fall-through code."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.Return, ast.Raise, ast.Break,
                                 ast.Continue)):
                consume_calls(stmt, state, seen)
                return True
            if isinstance(stmt, ast.If):
                consume_calls(stmt.test, state, seen)
                b, o = dict(state), dict(state)
                b_done = scan(stmt.body, b, seen)
                o_done = scan(stmt.orelse, o, seen)
                if b_done and o_done:
                    return True
                state.clear()  # re-merge: consumed in EITHER live branch
                if not b_done:
                    state.update(b)
                if not o_done:
                    state.update(o)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                consume_calls(stmt.iter, state, seen)
                for _ in range(2):  # twice: loop-carried reuse
                    # the target is rebound every iteration (`for key
                    # in keys:` draws under a fresh key each time)
                    clear_stores(_store_paths(stmt), state)
                    scan(stmt.body, state, seen)
                scan(stmt.orelse, state, seen)
            elif isinstance(stmt, ast.While):
                consume_calls(stmt.test, state, seen)
                for _ in range(2):
                    scan(stmt.body, state, seen)
                scan(stmt.orelse, state, seen)
            elif isinstance(stmt, ast.Try):
                scan(stmt.body, state, seen)
                for h in stmt.handlers:
                    scan(h.body, state, seen)
                scan(stmt.orelse, state, seen)
                scan(stmt.finalbody, state, seen)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    consume_calls(item.context_expr, state, seen)
                    clear_stores(_store_paths(item), state)
                scan(stmt.body, state, seen)
            else:
                consume_calls(stmt, state, seen)
                clear_stores(_store_paths(stmt), state)
        return False

    for _scope, body in _iter_scopes(tree):
        scan(body, {}, set())
    return findings


# -- rule 3a: wall clocks in replay-critical code ---------------------------


@register(
    "replay-wallclock",
    doc="no time.time()/time.monotonic() CALLS in replay-critical "
        "modules outside the injected-clock seams",
    applies=_in_replay_scope)
def check_replay_wallclock(tree, ctx):
    """Crash-replay parity (journal replay, eviction+resume, planner
    edge re-derivation) holds because no journaled DECISION reads the
    wall clock.  The sanctioned pattern is the injected-clock seam — a
    ``clock=time.monotonic`` parameter default (watchdog, breaker,
    planner) the caller can pin in tests and drills.  Only CALLS are
    flagged, so the uncalled seam reference is clean by construction —
    and a CALL in a parameter default (``def f(t=time.time())``) flags
    like any other: that is a timestamp frozen at import, reused for
    every invocation.  Wall-stamping telemetry fields that replay
    provably ignores is the legitimate exemption — say so in a
    ``# cetpu: noqa`` justification."""
    findings = []
    for node in _walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if name in _WALLCLOCKS:
            findings.append(ctx.finding(
                "replay-wallclock", node,
                f"{name}() in a replay-critical module; route through "
                "an injected-clock seam (clock= parameter) or justify "
                "via noqa that replay never reads this value"))
    return findings


# -- rule 3b: unseeded RNG in replay-critical code --------------------------


def _unseeded_generators(tree) -> list:
    """``torch.Generator(...)`` calls whose object is never seeded: not
    the receiver of a chained ``.manual_seed(...)``/``.set_state(...)``
    and not assigned to a path that such a call in the module seeds
    (``Generator.seed()`` draws a nondeterministic seed, so it does not
    count)."""
    seeded: set[str] = set()
    chained: set[int] = set()
    assigned: dict[int, list[str]] = {}
    for node in _walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("manual_seed", "set_state"):
            recv = node.func.value
            if isinstance(recv, ast.Call):
                chained.add(id(recv))
            elif _dotted(recv):
                seeded.add(_dotted(recv))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)) \
                and isinstance(node.value, ast.Call):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            assigned[id(node.value)] = [p for p in map(_dotted, targets)
                                        if p]
    return [node for node in _walk(tree)
            if isinstance(node, ast.Call)
            and _dotted(node.func) in ("torch.Generator", "Generator")
            and id(node) not in chained
            and not any(p in seeded for p in assigned.get(id(node), ()))]


@register(
    "replay-unseeded-rng",
    doc="no stdlib random / os.urandom / unseeded numpy or torch RNG in "
        "replay-critical modules",
    applies=_in_replay_scope)
def check_replay_unseeded_rng(tree, ctx):
    """Every random draw on the replay surface is seeded (backoff
    jitter, fault corruption, session keys) so a journal replay or a
    kill-matrix drill reproduces the run bit-for-bit.  The stdlib
    ``random`` module, ``os.urandom``, ``uuid.uuid4``, numpy's GLOBAL
    sampler state (``np.random.<sampler>()``, or ``default_rng()`` with
    no seed), torch's global generator (``torch.rand``/``randn``/
    ``randint``/``randperm``/``bernoulli``/``multinomial``/``normal``
    without ``generator=``) and a ``torch.Generator`` that is never
    ``manual_seed``-ed all break that."""
    findings = []
    for node in _unseeded_generators(tree):
        findings.append(ctx.finding(
            "replay-unseeded-rng", node,
            "torch.Generator() that is never manual_seed()-ed in a "
            "replay-critical module; seed it from the run seed"))
    for node in _walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "random":
                    findings.append(ctx.finding(
                        "replay-unseeded-rng", node,
                        "stdlib random imported in a replay-critical "
                        "module; use a seeded np.random.default_rng or "
                        "a prng key derived from the run seed"))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "random":
                findings.append(ctx.finding(
                    "replay-unseeded-rng", node,
                    "stdlib random imported in a replay-critical "
                    "module; use a seeded RNG"))
        elif isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name is None:
                continue
            if name in ("os.urandom", "uuid.uuid4"):
                findings.append(ctx.finding(
                    "replay-unseeded-rng", node,
                    f"{name}() is entropy the journal cannot replay; "
                    "derive from the run seed"))
                continue
            parts = name.split(".")
            if len(parts) == 2 and parts[0] == "torch" \
                    and parts[1] in _TORCH_SAMPLERS \
                    and not any(kw.arg == "generator"
                                for kw in node.keywords):
                findings.append(ctx.finding(
                    "replay-unseeded-rng", node,
                    f"{name}() without generator= draws from torch's "
                    "global RNG state; pass a seeded torch.Generator"))
                continue
            if len(parts) >= 3 and parts[-2] == "random" \
                    and parts[-3] in ("np", "numpy"):
                sampler = parts[-1]
                if sampler == "default_rng":
                    if not node.args and not node.keywords:
                        findings.append(ctx.finding(
                            "replay-unseeded-rng", node,
                            "np.random.default_rng() without a seed in "
                            "a replay-critical module"))
                elif sampler not in ("Generator", "SeedSequence",
                                     "BitGenerator", "PCG64"):
                    findings.append(ctx.finding(
                        "replay-unseeded-rng", node,
                        f"np.random.{sampler} uses numpy's global RNG "
                        "state; use a seeded default_rng instance"))
    return findings


# -- rule 3c: set-iteration order in replay-critical code -------------------


def _is_set_valued(node) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return _dotted(node.func) in ("set", "frozenset")
    return False


def _is_set_annotation(node) -> bool:
    if isinstance(node, ast.Subscript):
        node = node.value
    return _dotted(node) in ("set", "frozenset", "Set", "FrozenSet",
                             "typing.Set", "typing.FrozenSet")


def _typed_paths(tree, is_value, is_annotation) -> dict[int, set[str]]:
    """Per-scope dotted paths whose assigned value satisfies ``is_value``
    (or annotation ``is_annotation``), keyed by scope node id:

    - module scope: top-level names (direct statements only — a
      function-local of the same name must not taint the module);
    - each ClassDef: ``self.x`` attributes assigned/annotated anywhere
      in the class body (methods included);
    - each FunctionDef: ITS OWN locals (no descent into nested defs —
      they scope separately)."""

    out: dict[int, set[str]] = {}

    def direct_stmts(body):
        """Statements reachable without crossing a def/class boundary."""
        stack = list(body)
        while stack:
            stmt = stack.pop()
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            yield stmt
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list):
                    stack.extend(s for s in sub
                                 if isinstance(s, ast.stmt))
            for handler in getattr(stmt, "handlers", []) or []:
                stack.extend(handler.body)

    def collect(body, paths, *, attrs_only=False):
        for stmt in direct_stmts(body):
            if isinstance(stmt, ast.Assign) and is_value(stmt.value):
                for t in stmt.targets:
                    p = _dotted(t)
                    if p and (not attrs_only or p.startswith("self.")):
                        paths.add(p)
            elif isinstance(stmt, ast.AnnAssign) \
                    and is_annotation(stmt.annotation):
                p = _dotted(stmt.target)
                if p and (not attrs_only or p.startswith("self.")):
                    paths.add(p)

    module_paths: set[str] = set()
    collect(tree.body, module_paths)
    out[id(tree)] = module_paths
    for node in _walk(tree):
        if isinstance(node, ast.ClassDef):
            paths: set[str] = set()
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    collect(sub.body, paths, attrs_only=True)
            out[id(node)] = paths
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            paths = set()
            collect(node.body, paths)
            out[id(node)] = paths
    return out


def _set_typed_paths(tree) -> dict[int, set[str]]:
    """Per-scope set-typed dotted paths (see :func:`_typed_paths`)."""
    return _typed_paths(tree, _is_set_valued, _is_set_annotation)


def _annotate_active(tree, by_scope) -> dict[int, set[str]]:
    """node id -> typed paths visible there (module names, enclosing
    class self-attrs, enclosing function locals)."""
    active_at: dict[int, set[str]] = {}
    root = by_scope.get(id(tree), set())

    def annotate(node, active: set[str]):
        for child in ast.iter_child_nodes(node):
            cur = active
            if isinstance(child, (ast.ClassDef, ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                cur = active | by_scope.get(id(child), set())
            active_at[id(child)] = cur
            annotate(child, cur)

    active_at[id(tree)] = root
    annotate(tree, root)
    return active_at


@register(
    "replay-set-iteration",
    doc="no order-dependent iteration over sets in replay-critical "
        "modules (sorted() or an insertion-ordered dict instead)",
    applies=_in_replay_scope)
def check_replay_set_iteration(tree, ctx):
    """Python set iteration order varies with insertion history and hash
    seeds — two processes replaying the same journal can walk the same
    set differently.  Anything that feeds journaled or emitted output
    (finish records, assignment feeds, metrics lines) from a set walk
    is therefore nondeterministic across restarts.  Flags: ``for``
    loops and comprehensions iterating a set expression or a set-typed
    attribute, and order-capturing conversions (``list``/``tuple``/
    ``enumerate``/``iter``/``reversed``).  Order-independent reducers
    (``sorted``/``sum``/``min``/``max``/``any``/``all``/``len``) and
    membership tests stay silent."""
    findings = []
    by_scope = _set_typed_paths(tree)
    set_paths_global = by_scope.get(id(tree), set())
    active_at = _annotate_active(tree, by_scope)

    def is_set_expr(node) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name in ("set", "frozenset"):
                return True
        path = _dotted(node)
        if path is None:
            return False
        return path in active_at.get(id(node), set_paths_global)

    # comprehensions that feed an order-free reducer directly
    allowed_comps: set[int] = set()
    for node in _walk(tree):
        if isinstance(node, ast.Call) and node.args:
            name = _dotted(node.func)
            if name in _ORDER_FREE and isinstance(
                    node.args[0], (ast.GeneratorExp, ast.ListComp,
                                   ast.SetComp, ast.DictComp)):
                allowed_comps.add(id(node.args[0]))

    def flag(node, what):
        findings.append(ctx.finding(
            "replay-set-iteration", node,
            f"{what} over a set in a replay-critical module is "
            "order-nondeterministic across processes; sorted(...) it, "
            "or keep an insertion-ordered dict"))

    for node in _walk(tree):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            if is_set_expr(node.iter):
                flag(node.iter, "for-loop iteration")
        elif isinstance(node, (ast.GeneratorExp, ast.ListComp,
                               ast.SetComp, ast.DictComp)):
            if id(node) in allowed_comps:
                continue
            for gen in node.generators:
                if is_set_expr(gen.iter):
                    flag(gen.iter, "comprehension iteration")
        elif isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name in _ORDER_CAPTURE and len(node.args) == 1 \
                    and is_set_expr(node.args[0]):
                flag(node, f"{name}() conversion")
    return findings


# -- rule 4: implicit host sync in dispatch hot paths -----------------------


def _to_cpu(call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` /
    ``x.to(torch.device("cpu"))``."""
    args = list(call.args[:1]) + [kw.value for kw in call.keywords
                                  if kw.arg == "device"]
    for a in args:
        if isinstance(a, ast.Call) and _dotted(a.func) == "torch.device" \
                and a.args:
            a = a.args[0]
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
    return False


@register(
    "implicit-host-sync",
    doc="no float()/bool()/int()/.item()/.tolist()/.cpu()/.numpy()/"
        ".to('cpu')/np.asarray/torch.cuda.synchronize() in the "
        "scheduler dispatch hot path (transfers go through "
        "Acquirer.take_h2d)",
    applies=lambda path: path in HOT_PATH_FUNCS)
def check_implicit_host_sync(tree, ctx):
    """The stacked-dispatch pipeline stays asynchronous because no
    result row is pulled before every bucket's dispatch is in flight,
    and every host→device byte is graded through
    ``Acquirer.take_h2d``.  A ``float(x)``/``bool(x)``/``int(x)``/
    ``x.item()``/``x.tolist()``/``x.cpu()``/``x.numpy()``/
    ``x.to("cpu")``/``np.asarray(x)`` on a CUDA tensor inside the hot
    path is a hidden blocking d2h sync, and ``torch.cuda.synchronize()``
    an explicit one — it serializes the pipeline AND escapes the
    transfer accounting.  A pure-AST pass cannot tell a tensor from a
    host number, so ``int(n)`` of a Python int flags too: say so in a
    noqa."""
    findings = []
    hot = HOT_PATH_FUNCS.get(ctx.path, set())
    for node in _walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name not in hot:
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            name = _dotted(sub.func)
            if name is not None \
                    and name.split(".")[-1] in _SANCTIONED_PULLS:
                continue  # the one sanctioned selection-scalar pull
            msg = None
            if name in ("float", "bool") and len(sub.args) == 1:
                msg = (f"{name}() forces a blocking device→host sync "
                       "in the dispatch hot path")
            elif name == "int" and len(sub.args) == 1 \
                    and not isinstance(sub.args[0], ast.Constant):
                msg = ("int() forces a blocking device→host sync on a "
                       "tensor in the dispatch hot path")
            elif isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in ("item", "tolist", "cpu",
                                          "numpy") and not sub.args:
                msg = (f".{sub.func.attr}() forces a blocking device→host "
                       "sync in the dispatch hot path")
            elif isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "to" and _to_cpu(sub):
                msg = (".to('cpu') forces a blocking device→host sync in "
                       "the dispatch hot path")
            elif name == "torch.cuda.synchronize":
                msg = ("torch.cuda.synchronize() blocks the host on every "
                       "stream in the dispatch hot path")
            elif name in ("np.asarray", "numpy.asarray", "np.array",
                          "numpy.array"):
                msg = (f"{name}() pulls a device buffer to host outside "
                       "the Acquirer.take_h2d transfer accounting")
            if msg:
                findings.append(ctx.finding(
                    "implicit-host-sync", sub,
                    msg + "; keep rows device-resident (lazy slices) "
                          "or stage through the acquirer"))
    return findings


# -- rule 5: fault-point literals -------------------------------------------


def _is_fire_call(call) -> bool:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id == "fire"
    if isinstance(f, ast.Attribute) and f.attr == "fire":
        base = _dotted(f.value)
        return base is not None and base.split(".")[-1] == "faults"
    return False


@register(
    "fault-point-literal",
    doc="every faults.fire / FaultRule / fault_point string literal "
        "must name a registered resilience.faults.FAULT_POINTS member")
def check_fault_point_literal(tree, ctx):
    """The fault matrix only drills boundaries that EXIST: a typo'd
    ``faults.fire("serve.dipatch")`` never fires (the injector matches
    nothing) and its recovery path silently stops being exercised.
    ``FaultRule.__post_init__`` validates at RUNTIME — i.e. only when
    the drill runs (``faults.py``); this check resolves every literal
    statically: ``faults.fire("…")`` calls, ``FaultRule(point=…)``
    constructions, ``fault_point = "…"`` plan attributes, and
    ``parse_spec("point:action…")`` specs."""
    model = ctx.model
    if not model.fault_points:
        return []
    findings = []

    def check_point(node, value: str):
        if value not in model.fault_points:
            findings.append(ctx.finding(
                "fault-point-literal", node,
                f"fault point {value!r} is not in resilience.faults."
                f"FAULT_POINTS; register it there or fix the literal"))

    for node in _walk(tree):
        if isinstance(node, ast.Call):
            if _is_fire_call(node) and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str):
                    check_point(arg, arg.value)
            name = _dotted(node.func)
            last = name.split(".")[-1] if name else None
            if last == "FaultRule":
                point = None
                if node.args and isinstance(node.args[0], ast.Constant):
                    point = node.args[0]
                for kw in node.keywords:
                    if kw.arg == "point" \
                            and isinstance(kw.value, ast.Constant):
                        point = kw.value
                if point is not None and isinstance(point.value, str):
                    check_point(point, point.value)
            elif last == "parse_spec" and node.args:
                spec = node.args[0]
                if isinstance(spec, ast.Constant) \
                        and isinstance(spec.value, str):
                    for part in spec.value.split(","):
                        part = part.strip()
                        if ":" in part:
                            check_point(spec, part.split(":", 1)[0])
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, (ast.Name, ast.Attribute)) \
                        and (t.id if isinstance(t, ast.Name) else t.attr) \
                        == "fault_point" \
                        and isinstance(node.value, ast.Constant) \
                        and isinstance(node.value.value, str):
                    check_point(node.value, node.value.value)
    return findings


# -- rule 6: event-schema conformance ---------------------------------------


#: what a LITERAL argument node must look like per schema field kind.
#: Only literals are judged — a Name/Attribute/Call argument's runtime
#: type is unknowable to a pure-AST pass, so those always pass here and
#: ``obs.export.validate_metrics`` catches them at read time instead.
def _literal_kind_ok(kind, node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        v = node.value
        if kind == "str":
            return isinstance(v, str)
        if kind == "int":
            return isinstance(v, int) and not isinstance(v, bool)
        if kind == "float":
            return (isinstance(v, (int, float))
                    and not isinstance(v, bool))
        if kind == "list":
            return False  # a Constant is never a list literal
        return True
    if isinstance(node, (ast.List, ast.Tuple, ast.ListComp)):
        return kind == "list"
    if isinstance(node, (ast.Dict, ast.Set, ast.DictComp, ast.SetComp)):
        return False  # literally the wrong container for every kind
    # Name/Call/Attribute/...: runtime type unknowable to a pure-AST
    # pass — obs.export.validate_metrics judges it at read time
    return True


@register(
    "event-schema",
    doc="every report.event(...) / EventWriter.emit({...}) literal "
        "emit site must match obs.export.EVENT_FIELDS (fields AND "
        "literal argument types)")
def check_event_schema(tree, ctx):
    """``obs.export.validate_metrics`` rejects malformed records at READ
    time — after the run already emitted them.  This check moves the
    contract to the emit site: a literal event kind must be registered
    in ``EVENT_FIELDS``, the call's keyword set must cover the kind's
    required fields (a ``**kwargs`` splat defeats the field check but
    the kind is still verified), and a required field passed as a
    LITERAL must hold the field's registered type kind — the v2.1
    schema's str/int/float/list table (non-literal
    arguments are left to the runtime validator).  Extra fields are
    fine — the schema lists the floor, not the ceiling."""
    model = ctx.model
    if not model.event_fields:
        return []
    findings = []

    def check_kind(node, kind, present, has_splat):
        if kind not in model.event_fields:
            findings.append(ctx.finding(
                "event-schema", node,
                f"event kind {kind!r} is not in obs.export."
                f"EVENT_FIELDS; register it (with its required fields) "
                "or fix the literal"))
            return
        fields = model.event_fields[kind]
        if not has_splat:
            missing = [f for f in fields if f not in present]
            if missing:
                findings.append(ctx.finding(
                    "event-schema", node,
                    f"event {kind!r} emit site lacks required field(s) "
                    f"{missing}; EVENT_FIELDS requires "
                    f"{list(fields)}"))
        for field, value in present.items():
            want = fields.get(field) if isinstance(fields, dict) else None
            if want and value is not None \
                    and not _literal_kind_ok(want, value):
                findings.append(ctx.finding(
                    "event-schema", node,
                    f"event {kind!r} field {field!r} must be {want} "
                    f"(EVENT_FIELDS v2.1 kind table); this literal "
                    "argument is not"))

    for node in _walk(tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute):
            continue
        if node.func.attr == "event":
            if not node.args:
                continue
            kind = node.args[0]
            if not (isinstance(kind, ast.Constant)
                    and isinstance(kind.value, str)):
                continue
            present = {kw.arg: kw.value for kw in node.keywords
                       if kw.arg is not None}
            has_splat = any(kw.arg is None for kw in node.keywords)
            check_kind(node, kind.value, present, has_splat)
        elif node.func.attr == "emit" and len(node.args) == 1 \
                and isinstance(node.args[0], ast.Dict):
            d = node.args[0]
            keys = {}
            has_splat = False
            for k, v in zip(d.keys, d.values):
                if k is None:
                    has_splat = True  # {**rec} merge: keys unknowable
                elif isinstance(k, ast.Constant):
                    keys[k.value] = v
            kind = keys.get("event")
            if isinstance(kind, ast.Constant) \
                    and isinstance(kind.value, str):
                check_kind(node, kind.value, keys, has_splat)
    return findings


# -- rule 7: raw durable IO --------------------------------------------------


#: the durability-critical surface: every byte written here is either a
#: ledger (journal / WAL / feed), a lease, a checkpoint marker or a
#:  quarantine sidecar — all must route through ``resilience.io`` so the
#: ``io.*`` fault points cover them and the CRC framing discipline is
#: uniform
DURABLE_PREFIXES = (
    PKG + "serve/",
    PKG + "resilience/",
)
DURABLE_FILES = (
    PKG + "al/workspace.py",
)


def _in_durable_scope(path: str) -> bool:
    return path.startswith(DURABLE_PREFIXES) or path in DURABLE_FILES


@register(
    "raw-durable-io",
    doc="no direct open(w/a/x) / os.replace / os.fsync in "
        "durability-critical modules (route through resilience.io so "
        "the io.* fault points and CRC framing cover the write)",
    applies=_in_durable_scope)
def check_raw_durable_io(tree, ctx):
    """The storage-integrity guarantees hold only if every
    durable byte flows through ONE seam: ``resilience.io`` is where the
    ``io.write.*`` / ``io.fsync`` / ``io.rename`` fault points fire,
    where short writes and silent fsync drops are injected in the kill
    matrix, and where the CRC frame discipline lives.  A raw
    ``open(path, "w")`` in serve/ or resilience/ is a write the fault
    matrix cannot drill and fsck cannot reason about — it reintroduces
    exactly the torn-write blind spot the seam closed.  Flags literal
    write/append/exclusive open modes (positional or ``mode=``),
    ``os.replace`` and ``os.fsync``.  Read opens, ``r+b`` byte-surgery
    (the fault injector's corrupt action) and non-literal modes pass.
    The sanctioned escapes — the seam's own primitives, zero-byte lock
    siblings that carry no data — say so in a ``# cetpu: noqa`` why."""
    findings = []
    for node in _walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if name in ("os.replace", "os.fsync"):
            findings.append(ctx.finding(
                "raw-durable-io", node,
                f"direct {name}() in a durability-critical module; use "
                "resilience.io.replace/fsync (or atomic_write) so the "
                "io.* fault points cover the commit"))
            continue
        if name not in ("open", "io.open", "builtins.open"):
            continue
        mode = None
        if len(node.args) >= 2:
            mode = node.args[1]
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if not (isinstance(mode, ast.Constant)
                and isinstance(mode.value, str)):
            continue  # no/unknowable mode: a read, or runtime-chosen
        if any(c in mode.value for c in "wax"):
            findings.append(ctx.finding(
                "raw-durable-io", node,
                f"raw open(..., {mode.value!r}) in a durability-"
                "critical module; route the write through "
                "resilience.io (open_append/atomic_write/write) so "
                "fault drills and CRC framing cover it"))
    return findings


# -- rule 8: lock discipline -------------------------------------------------


_LOCK_CTORS = ("threading.Lock", "threading.RLock", "Lock", "RLock")


def _is_lock_valued(node) -> bool:
    return isinstance(node, ast.Call) and _dotted(node.func) in _LOCK_CTORS


def _is_lock_annotation(node) -> bool:
    return _dotted(node) in _LOCK_CTORS


def _lock_typed_paths(tree) -> dict[int, set[str]]:
    """Per-scope lock-typed dotted paths (see :func:`_typed_paths`):
    names/attributes assigned ``threading.Lock()`` / ``RLock()`` or
    annotated as such.  ``Condition``/``Semaphore`` are deliberately NOT
    tracked — their wait/notify protocols have their own shapes and the
    queue's ``with self._cond:`` idiom is already the sanctioned form."""
    return _typed_paths(tree, _is_lock_valued, _is_lock_annotation)


@register(
    "lock-discipline",
    doc="locks are held via `with` only (no bare .acquire()), and a "
        "second lock is never taken while one is held unless the pair "
        "is in the documented LOCK_ORDER table",
    applies=_in_pkg)
def check_lock_discipline(tree, ctx):
    """The fabric's threading model survives SIGKILL drills because its
    critical sections are trivially correct: every lock is taken with
    ``with`` (released on ANY exit — an exception inside a bare
    ``acquire()``/``release()`` pair leaks the lock and wedges the
    worker's intake or fence queue forever), and no code path holds two
    locks at once (two paths nesting the same pair in opposite orders is
    a deadlock that only fires under load, i.e. in the chaos soak, not
    in unit runs).  Flags: (a) any ``.acquire()`` call on a lock-typed
    path — ``with`` never spells it, so a bare acquire is always a
    hand-rolled critical section; (b) a ``with`` acquiring a lock-typed
    path while an enclosing ``with`` in the same function already holds
    one, unless that exact ``(outer, inner)`` pair is documented in
    :data:`LOCK_ORDER`.  Nested defs are separate control flow (they
    run later, maybe on another thread) and are scanned as their own
    scopes."""
    findings = []
    by_scope = _lock_typed_paths(tree)
    if not any(by_scope.values()):
        return findings
    active_at = _annotate_active(tree, by_scope)

    for node in _walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "acquire":
            path = _dotted(node.func.value)
            if path and path in active_at.get(id(node), set()):
                findings.append(ctx.finding(
                    "lock-discipline", node,
                    f"bare {path}.acquire() — hold locks via `with "
                    f"{path}:` so every exit path (including "
                    "exceptions) releases"))

    def with_lock_paths(stmt) -> list[str]:
        out = []
        for item in stmt.items:
            p = _dotted(item.context_expr)
            if p and p in active_at.get(id(stmt), set()):
                out.append(p)
        return out

    def scan(stmts, held: list[str]):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                acquired = with_lock_paths(stmt)
                # a multi-item `with a, b:` acquires left-to-right — the
                # earlier items are held while the later ones acquire
                for i, p in enumerate(acquired):
                    for h in held + acquired[:i]:
                        if (h, p) not in LOCK_ORDER:
                            findings.append(ctx.finding(
                                "lock-discipline", stmt,
                                f"lock {p!r} acquired while {h!r} is "
                                "held and the pair is not in the "
                                "documented LOCK_ORDER table; nested "
                                "locks deadlock the first time two "
                                "paths disagree on the order"))
                scan(stmt.body, held + acquired)
                continue
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list):
                    scan(sub, held)
            for handler in getattr(stmt, "handlers", []) or []:
                scan(handler.body, held)

    for _scope, body in _iter_scopes(tree):
        scan(body, [])
    return findings


# -- rule: deadline-discipline ----------------------------------------------


def _in_serve(path: str) -> bool:
    return path.startswith(PKG + "serve/")


def _sleep_calls(loop) -> list:
    """Sleep calls inside ``loop`` (nested defs excluded — separate
    control flow, scanned as their own loops if they have any)."""
    skip: set[int] = set()
    for node in ast.walk(loop):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            for sub in ast.walk(node):
                skip.add(id(sub))
    out = []
    for node in ast.walk(loop):
        if id(node) in skip or not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if name and name.split(".")[-1] == "sleep":
            out.append(node)
    return out


def _has_deadline_seam(loop) -> bool:
    """True when the loop's subtree references a bounding seam: a name
    or attribute whose spelling carries ``deadline``/``timeout``, or a
    clock read through the injected seam (``clock``/``_clock``) — the
    shapes every bounded poll loop in serve/ already uses."""
    for node in ast.walk(loop):
        if isinstance(node, ast.Name):
            ident = node.id
        elif isinstance(node, ast.Attribute):
            ident = node.attr
        else:
            continue
        low = ident.lower()
        if "deadline" in low or "timeout" in low or "clock" in low:
            return True
    return False


@register(
    "deadline-discipline",
    doc="serve/ never waits unboundedly: thread/process .join() calls "
        "carry a timeout, and a constant-condition poll loop that "
        "sleeps must read a deadline or the injected clock seam",
    applies=_in_serve)
def check_deadline_discipline(tree, ctx):
    """The gray-failure lesson, machine-checked: a wedged peer doesn't
    crash, it STALLS — and any unbounded wait in the serve plane turns
    one gray host into a wedged coordinator (the exact failure the
    stall/slow fault actions inject).  Two shapes are flagged:

    (a) a zero-argument ``.join()`` call — joining a thread or process
        with no timeout waits forever on a stalled peer (string
        ``sep.join(parts)`` always takes an argument, so a bare join is
        never the str method);
    (b) a ``while`` loop with a CONSTANT-truthy test whose body sleeps
        (``time.sleep`` et al.) but never references a bounding seam —
        no ``deadline``/``timeout`` name, no injected ``clock`` read —
        so nothing inside it can ever decide "too long".  Loops with a
        real exit condition (``while self._clock() < deadline``, the
        run loop's work-remaining test) are bounded by construction
        and stay clean.

    The escape hatch is the usual ``# cetpu: noqa[deadline-discipline]
    <why>`` — e.g. a loop whose bound lives one call down."""
    findings = []
    for node in _walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "join" \
                and not node.args and not node.keywords:
            findings.append(ctx.finding(
                "deadline-discipline", node,
                "bare .join() — pass timeout= (and handle the still-"
                "alive case) so a stalled peer can't hold this plane "
                "forever"))
        if isinstance(node, ast.While):
            test = node.test
            constant_truthy = (isinstance(test, ast.Constant)
                               and bool(test.value))
            if not constant_truthy:
                continue
            if _sleep_calls(node) and not _has_deadline_seam(node):
                findings.append(ctx.finding(
                    "deadline-discipline", node,
                    "unbounded poll loop: `while True` + sleep with no "
                    "deadline/timeout/injected-clock reference — give "
                    "it a deadline (or route the bound through the "
                    "clock seam) so a gray peer can't wedge it"))
    return findings
