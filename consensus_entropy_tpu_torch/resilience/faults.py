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
- ``delay`` sleeps ``delay_s`` (``delay=0.5``);
- ``stall`` holds the hit ``stall_s`` seconds (``stall=inf`` hangs until
  the process is killed): the gray species, a process alive (its
  heartbeat thread beats on) whose guarded operation wedges;
- ``slow`` multiplies the guarded operation's wall by ``slow_factor``:
  :func:`fire` arms the factor and the site calls :func:`slow_hold` with
  its measured elapsed time after the operation, which sleeps
  ``elapsed * (factor - 1)``.  It slows work down and changes no value.

``multihost.sync`` fires at each cross-process barrier.  The serve points
(``serve.admit``, ``serve.journal.append``, ``serve.dispatch``,
``serve.collect``, ``serve.feed.poll``) and the fabric's (``fabric.*``,
JAX ``resilience/faults.py:62-140``) are the JAX package's.
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
    "serve.admit",        # FleetServer slot refill, before the admit record
    "serve.journal.append",  # AdmissionJournal.append, before the write
    "serve.dispatch",     # FleetScheduler, each device dispatch
    "serve.collect",      # FleetServer completion, before the finish record
    "serve.feed.poll",    # JsonlTail.poll (a stall is a lagging tail)
    "fabric.compact",     # AdmissionJournal compaction (checkpoint, truncate)
    "fabric.assign",      # coordinator routing, before the assign record
    "fabric.lease",       # worker heartbeat, before the lease file write
    "fabric.spawn",       # autoscaler, before the spawn record
    "fabric.drain",       # scale-down decision, before the drain record
    "fabric.migrate.fence",   # in-flight migration, before the fence record
    "fabric.migrate.commit",  # after the fence ack, before the re-assign
    "fabric.remedy",      # remediation decision, before the remedy record
    "fabric.epoch",       # coordinator epoch claim, before the epoch record
    "fabric.gray",        # gray-ladder rung, before the probation record
    "multihost.sync",     # parallel.multihost.sync barriers
})

ACTIONS = ("kill", "raise", "transient", "corrupt", "delay", "stall",
           "slow")


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
    #: ``stall`` hold in seconds; ``float("inf")`` hangs until killed
    stall_s: float = 1.0
    #: ``slow`` wall-time multiplier honored by :func:`slow_hold`
    slow_factor: float = 2.0

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {self.point!r} "
                             f"(have {sorted(FAULT_POINTS)})")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(have {ACTIONS})")
        if self.at < 1:
            raise ValueError(f"at must be >= 1 (1-based hit), got {self.at}")
        if self.stall_s < 0:
            raise ValueError(f"stall_s must be >= 0, got {self.stall_s}")
        if self.slow_factor < 1:
            raise ValueError("slow_factor must be >= 1 (a multiplier on "
                             f"the guarded op's wall), got {self.slow_factor}")

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
        #: (thread id, point) -> the slow factor a matched ``slow`` rule
        #: armed, consumed by that thread's :meth:`slow_hold`
        self._slow_pending: dict[tuple, float] = {}

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
                if r.action == "slow":
                    skey = (threading.get_ident(), point)
                    self._slow_pending[skey] = max(
                        self._slow_pending.get(skey, 1.0), r.slow_factor)
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
            elif r.action == "stall":
                # the rest of the process (heartbeat, intake) runs on
                while r.stall_s == float("inf"):
                    time.sleep(3600)
                time.sleep(r.stall_s)
            elif r.action == "corrupt":
                payload = self._corrupt(payload, where)
        return payload

    def slow_hold(self, point: str, elapsed_s: float) -> None:
        """Honor the ``slow`` factor this thread's last :meth:`fire` of
        ``point`` armed: sleep ``elapsed * (factor - 1)``."""
        with self._lock:
            factor = self._slow_pending.pop(
                (threading.get_ident(), point), None)
        if factor is not None and factor > 1.0 and elapsed_s > 0:
            time.sleep(elapsed_s * (factor - 1.0))

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


def slow_hold(point: str, elapsed_s: float) -> None:
    """The ``slow`` action's hook: a site times its guarded operation and
    passes the elapsed seconds; a factor armed by this thread's preceding
    :func:`fire` of ``point`` stretches the operation to ``elapsed *
    factor``.  A no-op without an injector or a matched rule."""
    inj = _injector
    if inj is not None:
        inj.slow_hold(point, elapsed_s)


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


#: the valued actions and the :class:`FaultRule` field each value sets
_VALUED_ACTIONS = {"delay": "delay_s", "stall": "stall_s",
                   "slow": "slow_factor"}


def _parse_action(token: str) -> tuple[str, dict]:
    """``action`` or ``action=value`` -> ``(action, rule overrides)``,
    with the JAX package's errors for a malformed float or a value on an
    action that takes none."""
    action, sep, value = token.partition("=")
    if not sep:
        return action, {}
    field = _VALUED_ACTIONS.get(action)
    if field is None:
        keys = ", ".join(f"{k}=" for k in sorted(_VALUED_ACTIONS))
        raise ValueError(f"action {action!r} takes no '=value' suffix "
                         f"(valued actions: {keys})")
    try:
        parsed = float(value)
    except ValueError:
        raise ValueError(f"malformed float {value!r} for "
                         f"{action}=") from None
    return action, {field: parsed}


def parse_spec(spec: str) -> list[FaultRule]:
    """Parse the ``CETPU_FAULTS`` grammar: comma-separated
    ``point:action[=value][@at][xTIMES]``, e.g.
    ``state.save:kill@2,member.predict:corrupt@1x2``.  Valued actions:
    ``delay=0.5`` (seconds a firing), ``stall=5`` (``stall=inf`` hangs)
    and ``slow=20`` (a wall multiplier)."""
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
            action, overrides = _parse_action(rest)
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
