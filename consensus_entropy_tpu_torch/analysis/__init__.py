"""The port's static analysis: cetpu-lint's twelve rules over the port's
tree, in Python ``ast``.

Counterpart of ``consensus_entropy_tpu/analysis/`` (``engine.py``,
``model.py``, ``rules.py``, ``cli.py``), the port's own copy: it imports
neither JAX nor the JAX package.  The conventions it checks are the ones
the port's replay, durability and serving layers depend on: fused steps
update their mask operands in place (``ops.scoring.FUSED_MASKS``), every
PRNG key derives from the run seed, replay-critical code never reads a
wall clock or an unseeded RNG, every ``faults.fire`` literal names a
registered fault point, every schema-v2 emit site matches
``obs.export.EVENT_FIELDS``, and the dispatch hot path pulls nothing from
the card but the selection scalars.

- **pure host**: the pass imports nothing of the linted code.  The project
  model (:mod:`analysis.model`) reads the ``FAULT_POINTS`` /
  ``EVENT_FIELDS`` / ``FUSED_MASKS`` tables out of the source files with
  ``ast.literal_eval``, so the lint runs anywhere the tree was copied to.
- **suppressions are visible**: a finding is silenced per line with
  ``# cetpu: noqa[rule] <why>``, the same comment the JAX package's
  linter reads, or grandfathered in the package's baseline file
  (``analysis/lint_baseline.json``, kept EMPTY: fix it or noqa it).
- **registry**: rules self-register (:func:`analysis.engine.register`);
  ``python -m consensus_entropy_tpu_torch.analysis --list-rules`` prints
  the live table.
"""

from consensus_entropy_tpu_torch.analysis.engine import (
    Finding,
    LintResult,
    available_rules,
    lint_paths,
    lint_source,
    load_baseline,
    register,
)
from consensus_entropy_tpu_torch.analysis.model import ProjectModel

# importing the rules module populates the registry
from consensus_entropy_tpu_torch.analysis import rules as _rules  # noqa: F401

__all__ = [
    "Finding",
    "LintResult",
    "ProjectModel",
    "available_rules",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "register",
]
