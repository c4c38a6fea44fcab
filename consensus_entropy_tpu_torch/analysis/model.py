"""The project model: the port's contract tables, loaded WITHOUT imports.

Counterpart of ``consensus_entropy_tpu/analysis/model.py``.  The lint
rules check source against three registries that live in runtime modules
the linter must not import (``ops.scoring`` pulls in torch;
``resilience.faults`` activates ``CETPU_FAULTS`` on import):

- ``resilience.faults.FAULT_POINTS`` — the named fault-injection points,
- ``obs.export.EVENT_FIELDS`` — the schema-v2 event table,
- ``ops.scoring.FUSED_MASKS`` — per fused step, the positions of the mask
  operands it updates in place (the port's counterpart of the JAX
  package's ``FUSED_DONATE``: ``(pool position, hc position or None)``).

This module re-derives them by PARSING the defining files and
``ast.literal_eval``-ing the assigned literals — pure host, no project or
torch imports.  ``tests/test_torch_lint.py`` pins the parsed tables EQUAL
to the runtime objects, so the two cannot drift silently.
"""

from __future__ import annotations

import ast
import dataclasses
import os

PACKAGE = "consensus_entropy_tpu_torch"

#: (module-relative source file, assigned name) per table
_TABLE_SOURCES = {
    "fault_points": ("resilience/faults.py", "FAULT_POINTS"),
    "event_fields": ("obs/export.py", "EVENT_FIELDS"),
    "fused_masks": ("ops/scoring.py", "FUSED_MASKS"),
}


class ModelError(RuntimeError):
    """A contract table could not be statically recovered from source —
    its defining assignment moved, or stopped being a literal the loader
    can evaluate.  Update ``analysis.model`` alongside such a change."""


def _extract_assignment(path: str, name: str):
    """Evaluate the module-level ``name = <literal>`` assignment in
    ``path``.  ``frozenset({...})`` / ``set({...})`` / ``dict({...})``
    wrappers around a literal are unwrapped (``FAULT_POINTS`` is a
    ``frozenset`` call, which ``ast.literal_eval`` alone rejects)."""
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        if not any(isinstance(t, ast.Name) and t.id == name
                   for t in targets):
            continue
        value = node.value
        if (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id in ("frozenset", "set", "dict", "tuple")
                and len(value.args) == 1 and not value.keywords):
            value = value.args[0]
        try:
            return ast.literal_eval(value)
        except ValueError as e:
            raise ModelError(
                f"{path}: {name} is no longer a literal the lint model "
                f"can evaluate ({e}); keep the table a plain literal or "
                "teach analysis.model its new shape") from e
    raise ModelError(f"{path}: no module-level assignment to {name} "
                     "found (did the table move?)")


@dataclasses.dataclass(frozen=True)
class ProjectModel:
    """The statically recovered contract tables (see module docstring).
    ``fused_masks`` maps a fused step's key to the positions of every
    mask operand it updates in place."""

    fault_points: frozenset
    event_fields: dict
    fused_masks: dict

    @classmethod
    def load(cls, package_root: str) -> "ProjectModel":
        """``package_root``: the ``consensus_entropy_tpu_torch``
        directory."""
        values = {}
        for key, (rel, name) in _TABLE_SOURCES.items():
            values[key] = _extract_assignment(
                os.path.join(package_root, rel), name)
        return cls(fault_points=frozenset(values["fault_points"]),
                   event_fields={k: dict(v) for k, v
                                 in values["event_fields"].items()},
                   fused_masks={k: tuple(p for p in v if p is not None)
                                for k, v in values["fused_masks"].items()})

    @classmethod
    def from_repo(cls, root: str) -> "ProjectModel":
        """``root``: the repository root (holds the port's package)."""
        return cls.load(os.path.join(root, PACKAGE))

    @classmethod
    def empty(cls) -> "ProjectModel":
        """A model with no registered contracts — fixture tests use it to
        prove a rule stays silent without project tables."""
        return cls(fault_points=frozenset(), event_fields={},
                   fused_masks={})
