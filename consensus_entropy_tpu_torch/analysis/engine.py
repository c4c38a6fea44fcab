"""The lint engine: rule registry, suppression semantics, file walking.

Counterpart of ``consensus_entropy_tpu/analysis/engine.py``, unchanged in
behaviour: the same ``# cetpu: noqa[rule]`` syntax (one comment serves
both linters) and the same count-based baseline.

A rule is a callable ``(tree, ctx) -> iterable[Finding]`` registered
under a kebab-case name with a scope predicate over repo-relative paths.
The engine owns everything around the rules:

- **noqa**: a finding whose anchor line carries ``# cetpu: noqa[rule]``
  (or a bare ``# cetpu: noqa`` — all rules) is suppressed.  The bracket
  list is comma-separated rule names; anything after the bracket is the
  justification each suppression carries.
- **baseline**: grandfathered findings live in a checked-in JSON file
  mapping ``"<rule>:<path>"`` to a COUNT (counts, not line numbers, so
  unrelated edits don't invalidate entries).  Up to that many findings
  of the rule in the file are suppressed, lowest line first; new
  findings past the count still fail.  The ratchet direction: the
  package's committed baseline stays empty, fixtures exercise the format.
- **walking**: ``lint_paths`` expands directories to ``*.py`` files
  (skipping ``__pycache__``/hidden dirs), parses each once, and runs
  every in-scope rule over the shared tree.  ``lint_source`` is the
  test surface: lint a source string AS IF it lived at a given
  repo-relative path, so fixtures exercise path-scoped rules without
  touching the real tree.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import time

from consensus_entropy_tpu_torch.analysis.model import ProjectModel

_NOQA_RE = re.compile(
    r"#\s*cetpu:\s*noqa(?:\[(?P<rules>[a-z0-9_,\- ]+)\])?", re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str      # repo-relative, forward slashes
    line: int      # 1-based anchor line
    col: int
    message: str

    def key(self) -> str:
        """The baseline bucket this finding counts against."""
        return f"{self.rule}:{self.path}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"[{self.rule}] {self.message}")


@dataclasses.dataclass
class LintContext:
    """Per-file state handed to every rule."""

    path: str                 # repo-relative
    source: str
    lines: list[str]
    model: ProjectModel

    def finding(self, rule: str, node, message: str) -> Finding:
        return Finding(rule=rule, path=self.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0),
                       message=message)


@dataclasses.dataclass
class _Rule:
    name: str
    doc: str
    check: object                      # (tree, ctx) -> iterable[Finding]
    applies: object                    # (rel_path) -> bool


_REGISTRY: dict[str, _Rule] = {}


def register(name: str, *, doc: str, applies=None):
    """Decorator: add a rule to the registry.  ``applies(rel_path)``
    scopes the rule (default: every linted file)."""
    if not re.fullmatch(r"[a-z0-9][a-z0-9\-]*", name):
        raise ValueError(f"rule names are kebab-case, got {name!r}")

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"duplicate rule {name!r}")
        _REGISTRY[name] = _Rule(name=name, doc=doc, check=fn,
                                applies=applies or (lambda path: True))
        return fn

    return deco


def available_rules() -> dict[str, str]:
    """``{name: one-line doc}`` for the live registry."""
    return {name: rule.doc for name, rule in sorted(_REGISTRY.items())}


# -- suppression semantics ---------------------------------------------------


def _noqa_rules(line: str) -> set[str] | None:
    """Rules suppressed by this physical line: ``None`` when no noqa
    comment, the empty set for a bare ``# cetpu: noqa`` (ALL rules),
    otherwise the named set."""
    m = _NOQA_RE.search(line)
    if m is None:
        return None
    rules = m.group("rules")
    if rules is None:
        return set()
    return {r.strip() for r in rules.split(",") if r.strip()}


def apply_noqa(findings: list[Finding], lines: list[str]) -> list[Finding]:
    out = []
    for f in findings:
        line = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        suppressed = _noqa_rules(line)
        if suppressed is not None and (not suppressed
                                       or f.rule in suppressed):
            continue
        out.append(f)
    return out


def load_baseline(path: str | None) -> dict[str, int]:
    if not path or not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        raw = json.load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: baseline must be a JSON object "
                         "mapping 'rule:path' to a count")
    return {str(k): int(v) for k, v in raw.items()}


def apply_baseline(findings: list[Finding],
                   baseline: dict[str, int]) -> list[Finding]:
    """Suppress up to ``baseline[key]`` findings per (rule, path) bucket,
    lowest line first — count-based, so unrelated edits in the file
    don't invalidate the grandfathering."""
    if not baseline:
        return list(findings)
    budget = dict(baseline)
    out = []
    for f in sorted(findings, key=lambda f: (f.path, f.rule, f.line,
                                             f.col)):
        if budget.get(f.key(), 0) > 0:
            budget[f.key()] -= 1
            continue
        out.append(f)
    return out


def baseline_from(findings: list[Finding]) -> dict[str, int]:
    """The ``--write-baseline`` payload for the current findings."""
    out: dict[str, int] = {}
    for f in findings:
        out[f.key()] = out.get(f.key(), 0) + 1
    return dict(sorted(out.items()))


# -- running -----------------------------------------------------------------


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]      # after noqa + baseline
    suppressed: int              # noqa'd findings
    baselined: int               # baseline-absorbed findings
    files: int
    errors: list[str]            # unparseable files
    wall_s: float

    @property
    def clean(self) -> bool:
        return not self.findings and not self.errors


def _select(select) -> list[_Rule]:
    if select is None:
        return list(_REGISTRY.values())
    unknown = set(select) - set(_REGISTRY)
    if unknown:
        raise ValueError(f"unknown rule(s) {sorted(unknown)} "
                         f"(have {sorted(_REGISTRY)})")
    return [_REGISTRY[name] for name in select]


def lint_source(source: str, rel_path: str, *, model: ProjectModel,
                select=None) -> list[Finding]:
    """Lint one source string as if it lived at ``rel_path`` (the test
    surface — path-scoped rules see the virtual location).  Returns
    noqa-filtered findings; baseline is the caller's concern."""
    lines = source.splitlines()
    tree = ast.parse(source, filename=rel_path)
    ctx = LintContext(path=rel_path, source=source, lines=lines,
                      model=model)
    findings: list[Finding] = []
    for rule in _select(select):
        if rule.applies(rel_path):
            findings.extend(rule.check(tree, ctx))
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return apply_noqa(findings, lines)


def _iter_py_files(paths: list[str], root: str):
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if not os.path.exists(full):
            # a typo'd path must FAIL, not lint zero files and pass —
            # a CI gate pointed at a missing directory would otherwise
            # stay green forever
            raise ValueError(f"lint path does not exist: {p!r} "
                             f"(resolved {full!r})")
        if os.path.isfile(full):
            yield full
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(
                d for d in dirnames
                if not d.startswith(".") and d != "__pycache__")
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    yield os.path.join(dirpath, fname)


def lint_paths(paths: list[str], *, root: str,
               model: ProjectModel | None = None, select=None,
               baseline: dict[str, int] | None = None) -> LintResult:
    """Lint files/directories under ``root``; see :class:`LintResult`."""
    t0 = time.perf_counter()
    model = model or ProjectModel.from_repo(root)
    rules = _select(select)
    raw: list[Finding] = []
    kept: list[Finding] = []
    errors: list[str] = []
    files = 0
    for full in _iter_py_files(paths, root):
        rel = os.path.relpath(full, root).replace(os.sep, "/")
        try:
            with open(full, "r", encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=rel)
        except (SyntaxError, ValueError, OSError) as e:
            errors.append(f"{rel}: unparseable ({e})")
            continue
        files += 1
        lines = source.splitlines()
        ctx = LintContext(path=rel, source=source, lines=lines,
                          model=model)
        file_findings: list[Finding] = []
        for rule in rules:
            if rule.applies(rel):
                file_findings.extend(rule.check(tree, ctx))
        file_findings.sort(key=lambda f: (f.line, f.col, f.rule))
        raw.extend(file_findings)
        kept.extend(apply_noqa(file_findings, lines))
    suppressed = len(raw) - len(kept)
    final = apply_baseline(kept, baseline or {})
    return LintResult(findings=final, suppressed=suppressed,
                      baselined=len(kept) - len(final), files=files,
                      errors=errors,
                      wall_s=round(time.perf_counter() - t0, 3))
