"""The port's lint entry point: cetpu-lint's command line over the port.

Counterpart of ``consensus_entropy_tpu/analysis/cli.py`` with the same
flags, and of ``scripts/lint_check.sh``'s wall-time gate: a pass that
takes WALL_BUDGET_S or more exits 1 whatever it found.  Pure host (no
torch import on this path): parses the tree, loads the contract tables
from source, prints text or JSON findings, and exits nonzero on any
unsuppressed finding.

    python -m consensus_entropy_tpu_torch.analysis           # the port
    python -m consensus_entropy_tpu_torch.analysis --format json
    python -m consensus_entropy_tpu_torch.analysis --list-rules
    python -m consensus_entropy_tpu_torch.analysis \\
        --select fault-point-literal,event-schema chip_smoke.py
    python -m consensus_entropy_tpu_torch.analysis --write-baseline
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from consensus_entropy_tpu_torch.analysis import (  # noqa: F401 (rules register)
    available_rules,
    lint_paths,
    load_baseline,
)
from consensus_entropy_tpu_torch.analysis.engine import baseline_from
from consensus_entropy_tpu_torch.analysis.model import (
    PACKAGE,
    ModelError,
    ProjectModel,
)

#: what "the port's tree" means when no paths are given (globs expanded
#: under the root)
DEFAULT_PATHS = (PACKAGE, "chip_smoke.py", "tests/test_torch_*.py",
                 "tests/torch_*.py")
#: the baseline, relative to the root: inside the package, so the JAX
#: package's ``lint_baseline.json`` stays that package's
BASELINE_FILE = os.path.join(PACKAGE, "analysis", "lint_baseline.json")
#: a full-tree pass must stay interactive (``scripts/lint_check.sh``)
WALL_BUDGET_S = 10.0


def _find_root(start: str) -> str:
    """Walk up from ``start`` to the directory holding the port's
    package — lets the lint run from anywhere inside the repo."""
    cur = os.path.abspath(start)
    while True:
        if os.path.isdir(os.path.join(cur, PACKAGE)):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            raise SystemExit(
                f"cetpu-lint: no {PACKAGE} package found above "
                f"{start!r}; pass --root")
        cur = parent


def default_paths(root: str) -> list[str]:
    """DEFAULT_PATHS expanded under ``root``, repo-relative, sorted."""
    out = []
    for pattern in DEFAULT_PATHS:
        hits = sorted(glob.glob(os.path.join(root, pattern)))
        out += [os.path.relpath(h, root) for h in hits]
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m consensus_entropy_tpu_torch.analysis",
        description="the port's static analysis: mask-update, PRNG, "
                    "replay-determinism, host-sync and schema discipline "
                    "(cetpu-lint's rules over the port's tree)")
    p.add_argument("paths", nargs="*",
                   help=f"files/directories to lint, relative to the "
                        f"repo root (default: {' '.join(DEFAULT_PATHS)})")
    p.add_argument("--root", default=None,
                   help="repository root (default: walk up from cwd to "
                        f"the directory holding {PACKAGE})")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="finding report format (default text)")
    p.add_argument("--select", default=None, metavar="RULE[,RULE...]",
                   help="run only these rules")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help=f"baseline file (default <root>/{BASELINE_FILE} "
                        "when it exists)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline file (report everything)")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the current findings to the baseline "
                        "file and exit 0 (the grandfathering ratchet)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule registry and exit")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for name, doc in available_rules().items():
            print(f"{name:24} {doc}")
        return 0
    root = args.root or _find_root(os.getcwd())
    paths = args.paths or default_paths(root)
    select = [s.strip() for s in args.select.split(",")] \
        if args.select else None
    baseline_path = args.baseline or os.path.join(root, BASELINE_FILE)
    try:
        model = ProjectModel.from_repo(root)
        baseline = {} if (args.no_baseline or args.write_baseline) \
            else load_baseline(baseline_path)
        result = lint_paths(paths, root=root, model=model, select=select,
                            baseline=baseline)
    except (ModelError, ValueError) as e:
        print(f"cetpu-lint: {e}", file=sys.stderr)
        return 2
    if args.write_baseline:
        if result.errors:
            # a baseline computed while files failed to parse is
            # incomplete — refuse rather than grandfather a lie
            for e in result.errors:
                print(f"cetpu-lint: ERROR: {e}", file=sys.stderr)
            print("cetpu-lint: refusing to write a baseline while "
                  f"{len(result.errors)} file(s) are unparseable",
                  file=sys.stderr)
            return 2
        payload = baseline_from(result.findings)
        with open(baseline_path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"cetpu-lint: wrote {len(payload)} baseline bucket(s) "
              f"({len(result.findings)} finding(s)) to {baseline_path}",
              file=sys.stderr)
        return 0
    too_slow = result.wall_s >= WALL_BUDGET_S
    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in result.findings],
            "errors": result.errors,
            "files": result.files,
            "suppressed": result.suppressed,
            "baselined": result.baselined,
            "wall_s": result.wall_s,
        }))
    else:
        for f in result.findings:
            print(str(f))
        for e in result.errors:
            print(f"ERROR: {e}")
        status = "clean" if result.clean else (
            f"{len(result.findings)} finding(s)"
            + (f", {len(result.errors)} parse error(s)"
               if result.errors else ""))
        print(f"cetpu-lint: {result.files} file(s) in {result.wall_s}s "
              f"— {status} ({result.suppressed} noqa'd, "
              f"{result.baselined} baselined)", file=sys.stderr)
    if too_slow:
        print(f"cetpu-lint: the pass took {result.wall_s}s (>= "
              f"{WALL_BUDGET_S}s budget)", file=sys.stderr)
    return 0 if result.clean and not too_slow else 1


if __name__ == "__main__":
    raise SystemExit(main())
