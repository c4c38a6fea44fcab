"""Deterministic fault injection at named boundaries.

Counterpart of ``consensus_entropy_tpu/resilience/faults.py``, trimmed to
the points the AL loop and its workspace fire: the same point names, the
same ``CETPU_FAULTS`` grammar (``point:action[=value][@at][xTIMES]``,
comma-separated) and the same per-point hit counters, so a drill spelled
for one package kills the other at the same boundary.

Actions:

- ``kill`` raises :class:`InjectedKill` (a ``BaseException``): process
  death at that boundary; no recovery handler may absorb it;
- ``raise`` raises :class:`InjectedFault`, which member quarantine absorbs;
- ``transient`` raises :class:`TransientFault`, which the bounded retry
  absorbs;
- ``corrupt`` flips a file payload's last byte, or sets an array payload's
  first row to NaN;
- ``delay`` sleeps ``delay_s`` (``delay=0.5``).

``multihost.sync`` fires at each cross-process barrier.  Of the serve
points only ``serve.dispatch`` (the fleet scheduler's device dispatches)
is here; the others, the fabric points and the gray
``stall``/``slow`` actions wait for the serving layer (ROADMAP A10).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

import numpy as np

FAULT_POINTS = frozenset({
    "checkpoint.write",   # Committee.save, per member file
    "member.retrain",     # Committee.update_host / update_host_gated
    "member.predict",     # Committee.pool_probs, per host member
    "pool.score",         # the loop's score phase (whole probs table)
    "acquire.qbdc.masks",  # Committee._qbdc_stage, before the mask draw
    "state.save",         # al.state.ALState.save (the commit point)
    "io.write.short",     # resilience.io.write: half the payload lands
    "io.write.enospc",    # raise -> OSError(ENOSPC) before any byte
    "io.write.eio",       # raise -> OSError(EIO) before any byte
    "io.fsync",           # raise -> the fsync is dropped
    "io.rename",          # raise -> the atomic rename fails with EIO
    "serve.dispatch",     # FleetScheduler, each device dispatch
    "multihost.sync",     # parallel.multihost.sync barriers
})

ACTIONS = ("kill", "raise", "transient", "corrupt", "delay")


class InjectedFault(Exception):
    """A recoverable injected member or IO failure."""


class TransientFault(InjectedFault):
    """An injected transient error (the retry path)."""


class InjectedKill(BaseException):
    """Simulated process death: no ``except Exception`` handler catches
    it."""


@dataclasses.dataclass
class FaultRule:
    """Fire ``action`` at hits ``[at, at + times)`` of ``point`` (1-based;
    ``times=-1`` forever).  ``member`` restricts the rule to fires carrying
    that ``member=`` context, counted per (point, member)."""

    point: str
    action: str
    at: int = 1
    times: int = 1
    delay_s: float = 0.01
    member: str | None = None

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {self.point!r} "
                             f"(have {sorted(FAULT_POINTS)})")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(have {ACTIONS})")
        if self.at < 1:
            raise ValueError(f"at must be >= 1 (1-based hit), got {self.at}")

    def matches(self, hit: int, ctx: dict) -> bool:
        if self.member is not None and ctx.get("member") != self.member:
            return False
        if hit < self.at:
            return False
        return self.times < 0 or hit < self.at + self.times


def _corrupt_file(path: str) -> None:
    """Flip the last byte in place."""
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            return
        f.seek(size - 1)
        byte = f.read(1)
        f.seek(size - 1)
        f.write(bytes([byte[0] ^ 0xFF]))


class FaultInjector:
    """Rule store and per-point hit counters (thread-safe: checkpoint
    writes run on the checkpointer's thread)."""

    def __init__(self, rules):
        self.rules = [r if isinstance(r, FaultRule) else FaultRule(**r)
                      for r in rules]
        self.hits: dict[str, int] = {}
        self.member_hits: dict[tuple, int] = {}
        self.fired: list[dict] = []
        self._lock = threading.Lock()

    def fire(self, point: str, payload=None, **ctx):
        with self._lock:
            hit = self.hits.get(point, 0) + 1
            self.hits[point] = hit
            mhit = None
            if "member" in ctx:
                mkey = (point, ctx["member"])
                mhit = self.member_hits.get(mkey, 0) + 1
                self.member_hits[mkey] = mhit
            todo = [r for r in self.rules if r.point == point
                    and r.matches(hit if r.member is None else mhit, ctx)]
            for r in todo:
                self.fired.append({"point": point, "action": r.action,
                                   "hit": hit, **ctx})
        for r in todo:
            where = f"{point} hit {hit}" + (
                f" ({ctx['member']})" if "member" in ctx else "")
            if r.action == "kill":
                raise InjectedKill(f"injected kill at {where}")
            if r.action == "raise":
                raise InjectedFault(f"injected fault at {where}")
            if r.action == "transient":
                raise TransientFault(f"injected transient error at {where}")
            if r.action == "delay":
                time.sleep(r.delay_s)
            elif r.action == "corrupt":
                payload = self._corrupt(payload, where)
        return payload

    @staticmethod
    def _corrupt(payload, where: str):
        if isinstance(payload, (str, os.PathLike)):
            _corrupt_file(os.fspath(payload))
            return payload
        if isinstance(payload, np.ndarray):
            out = payload.astype(np.float64 if payload.dtype.kind != "f"
                                 else payload.dtype, copy=True)
            out[(0,) * max(out.ndim - 1, 0)] = np.nan  # first row -> NaN
            return out
        raise InjectedFault(f"injected corruption at {where} "
                            f"(payload {type(payload).__name__} is not "
                            "corruptible; treating as a hard fault)")


_injector: FaultInjector | None = None


def install(injector: FaultInjector | None) -> None:
    global _injector
    _injector = injector


def fire(point: str, payload=None, **ctx):
    """The instrumented-site hook: returns ``payload`` unchanged unless an
    injector is installed and a rule matches this hit."""
    inj = _injector
    if inj is None:
        return payload
    return inj.fire(point, payload=payload, **ctx)


@contextlib.contextmanager
def inject(*rules):
    """Install an injector for the block; yields it (``.fired`` is the
    audit trail).  The previous injector is restored on exit."""
    prev = _injector
    inj = FaultInjector(rules)
    install(inj)
    try:
        yield inj
    finally:
        install(prev)


def parse_spec(spec: str) -> list[FaultRule]:
    """Parse the ``CETPU_FAULTS`` grammar: comma-separated
    ``point:action[=value][@at][xTIMES]``, e.g.
    ``state.save:kill@2,member.predict:corrupt@1x2``; ``delay=0.5`` is the
    one valued action."""
    rules = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        try:
            point, rest = part.split(":", 1)
            times = 1
            if "x" in rest:
                rest, times_s = rest.rsplit("x", 1)
                times = int(times_s)
            at = 1
            if "@" in rest:
                rest, at_s = rest.split("@", 1)
                at = int(at_s)
            action, sep, value = rest.partition("=")
            overrides = {}
            if sep:
                if action != "delay":
                    raise ValueError(f"action {action!r} takes no '=value' "
                                     "suffix (valued actions: delay=)")
                overrides["delay_s"] = float(value)
            rules.append(FaultRule(point=point, action=action, at=at,
                                   times=times, **overrides))
        except ValueError as e:
            raise ValueError(
                f"bad CETPU_FAULTS entry {part!r} (want "
                f"point:action[=value][@at][xTIMES]): {e}") from e
    return rules


def install_from_env(env: str = "CETPU_FAULTS") -> FaultInjector | None:
    """Activate the injector from the environment (once, at import; a
    no-op when the variable is unset)."""
    spec = os.environ.get(env)
    if not spec:
        return None
    inj = FaultInjector(parse_spec(spec))
    install(inj)
    return inj


install_from_env()
