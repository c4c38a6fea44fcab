"""The trace model: pure, seeded load-shape generators and the versioned
``trace.jsonl`` grammar a serving run replays from.

Counterpart of ``consensus_entropy_tpu/workload/trace.py`` (``:74-383``):
the same spec, the same draws in the same order from one
``numpy.random.default_rng(seed)`` stream and the same canonical
serialization, so a trace generated from one spec is the same bytes (and
the same :func:`trace_digest`) from either package.

A trace is the whole workload, decided up front: who arrives, when, in
which priority class, with what pool size, and which users churn
(disconnect mid-run, reconnect later).  The driver (:mod:`workload.
driver`) only plays the file.

Grammar (one JSON object per line)::

    {"schema": 1, "kind": "trace_header", "seed": .., "n_users": .., ...}
    {"kind": "arrive",     "t": 0.18, "user": "u0", "cls": "interactive",
     "pool": 30}
    {"kind": "disconnect", "t": 2.75, "user": "u0"}
    {"kind": "reconnect",  "t": 4.75, "user": "u0"}

``t`` is seconds from trace start (the driver scales it by
``time_scale``); events sort by ``(t, user, kind)``.

Arrival processes: ``poisson`` (exponential gaps at ``rate``), ``mmpp``
(calm periods at ``rate`` alternating with bursts at ``burst_rate``) and
``replay`` (explicit ``timestamps``).  Pool-size distributions:
``bucket`` (uniform over ``pool_sizes``), ``skew`` (about 80% of users on
one size) and ``cycle`` (round-robin).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

#: the trace-file schema version (independent of the metrics stream's)
TRACE_SCHEMA = 1

ARRIVALS = ("poisson", "mmpp", "replay")
POOL_DISTS = ("bucket", "skew", "cycle")
EVENT_KINDS = ("arrive", "disconnect", "reconnect")

#: adversarial-skew mass on the dominant pool size (the rest spread
#: uniformly) — enough to wedge one bucket without emptying the others
SKEW_FRAC = 0.8


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """One trace's full recipe — hashable, serializable into the header
    line, and sufficient to regenerate the trace bit-for-bit."""

    seed: int = 0
    n_users: int = 8
    #: arrival process: ``poisson`` | ``mmpp`` | ``replay``
    arrival: str = "poisson"
    #: mean arrivals/sec (poisson; the CALM state under mmpp)
    rate: float = 4.0
    #: mmpp burst-state arrivals/sec (0 → ``8 * rate``)
    burst_rate: float = 0.0
    #: mean seconds spent in each mmpp state before switching
    burst_dwell_s: float = 1.0
    #: explicit arrival offsets for ``arrival="replay"`` (seconds)
    timestamps: tuple = ()
    #: ``((class, weight), ...)`` priority mix, weights normalized
    class_mix: tuple = (("interactive", 0.5), ("batch", 0.5))
    #: pool-size distribution: ``bucket`` | ``skew`` | ``cycle``
    pool_dist: str = "bucket"
    pool_sizes: tuple = (12, 30, 60, 120)
    #: fraction of users that churn (disconnect + reconnect)
    churn_frac: float = 0.0
    #: mean seconds after its arrival a churning user disconnects
    churn_delay_s: float = 1.0
    #: mean seconds a churned user stays away before reconnecting
    reconnect_s: float = 2.0
    #: stretch/compress arrivals so the LAST arrival lands here (None
    #: keeps the raw process timescale) — how a soak pins its wall span
    horizon_s: float | None = None

    def __post_init__(self):
        if self.n_users < 1:
            raise ValueError(f"n_users must be >= 1, got {self.n_users}")
        if self.arrival not in ARRIVALS:
            raise ValueError(f"arrival must be one of {ARRIVALS}, "
                             f"got {self.arrival!r}")
        if self.arrival == "replay":
            if len(self.timestamps) != self.n_users:
                raise ValueError(
                    f"replay needs one timestamp per user: "
                    f"{len(self.timestamps)} != {self.n_users}")
            if any(t < 0 for t in self.timestamps):
                raise ValueError("replay timestamps must be >= 0")
        elif self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if self.arrival == "mmpp" and self.burst_dwell_s <= 0:
            raise ValueError(f"burst_dwell_s must be > 0, "
                             f"got {self.burst_dwell_s}")
        if not self.class_mix \
                or any(w < 0 for _, w in self.class_mix) \
                or sum(w for _, w in self.class_mix) <= 0:
            raise ValueError(f"class_mix needs positive total weight, "
                             f"got {self.class_mix!r}")
        if self.pool_dist not in POOL_DISTS:
            raise ValueError(f"pool_dist must be one of {POOL_DISTS}, "
                             f"got {self.pool_dist!r}")
        if not self.pool_sizes or any(int(n) < 1
                                      for n in self.pool_sizes):
            raise ValueError(f"pool_sizes must be positive, "
                             f"got {self.pool_sizes!r}")
        if not 0 <= self.churn_frac <= 1:
            raise ValueError(f"churn_frac must be in [0, 1], "
                             f"got {self.churn_frac}")
        if self.churn_delay_s <= 0 or self.reconnect_s <= 0:
            raise ValueError("churn_delay_s and reconnect_s must be > 0")
        if self.horizon_s is not None and self.horizon_s <= 0:
            raise ValueError(f"horizon_s must be > 0, "
                             f"got {self.horizon_s}")


@dataclasses.dataclass
class Trace:
    """A generated (or loaded) trace: the header metadata and the sorted
    event list.  ``events`` are plain dicts in the file grammar."""

    meta: dict
    events: list

    @property
    def users(self) -> list:
        """Every user id, in arrival order."""
        return [e["user"] for e in self.events if e["kind"] == "arrive"]

    @property
    def horizon_s(self) -> float:
        """The last event's offset (0.0 for a degenerate trace)."""
        return max((e["t"] for e in self.events), default=0.0)


def _round_t(t: float) -> float:
    """One canonical rounding for every timestamp the grammar carries:
    6 decimals survive a JSON round-trip exactly, so generate → save →
    load → save is byte-stable (the round-trip pin)."""
    return round(float(t), 6)


def _arrival_times(spec: TraceSpec, rng) -> list:
    if spec.arrival == "replay":
        return [float(t) for t in spec.timestamps]
    if spec.arrival == "poisson":
        gaps = rng.exponential(1.0 / spec.rate, size=spec.n_users)
        return list(np.cumsum(gaps))
    # mmpp: alternate calm/burst states, each dwelling an exponential
    # time, emitting exponential gaps at the state's rate.  One rng
    # stream, fixed draw order — regeneration is bit-identical.
    burst = spec.burst_rate if spec.burst_rate > 0 else 8.0 * spec.rate
    times, t, state_rate, remaining = [], 0.0, spec.rate, 0.0
    while len(times) < spec.n_users:
        if remaining <= 0:
            remaining = float(rng.exponential(spec.burst_dwell_s))
            state_rate = burst if state_rate == spec.rate else spec.rate
        gap = float(rng.exponential(1.0 / state_rate))
        if gap > remaining:
            t += remaining
            remaining = 0.0
            continue
        t += gap
        remaining -= gap
        times.append(t)
    return times


def _assign_classes(spec: TraceSpec, rng) -> list:
    names = [c for c, _ in spec.class_mix]
    weights = np.array([w for _, w in spec.class_mix], dtype=np.float64)
    weights = weights / weights.sum()
    idx = rng.choice(len(names), size=spec.n_users, p=weights)
    return [names[int(i)] for i in idx]


def _assign_pools(spec: TraceSpec, rng) -> list:
    sizes = [int(n) for n in spec.pool_sizes]
    if spec.pool_dist == "cycle":
        return [sizes[i % len(sizes)] for i in range(spec.n_users)]
    if spec.pool_dist == "skew":
        # the adversarial shape: SKEW_FRAC of the mass on one size (the
        # seeded rng picks which), the rest uniform over the others
        hot = int(rng.integers(0, len(sizes)))
        p = np.full(len(sizes), (1.0 - SKEW_FRAC) / max(len(sizes) - 1, 1))
        p[hot] = SKEW_FRAC if len(sizes) > 1 else 1.0
        idx = rng.choice(len(sizes), size=spec.n_users, p=p)
        return [sizes[int(i)] for i in idx]
    idx = rng.integers(0, len(sizes), size=spec.n_users)
    return [sizes[int(i)] for i in idx]


def generate(spec: TraceSpec) -> Trace:
    """Spec → trace, pure and seeded: every draw comes from one
    ``default_rng(spec.seed)`` stream in a fixed order, so the same spec
    regenerates the identical trace (and thus the identical file)."""
    rng = np.random.default_rng(spec.seed)
    times = _arrival_times(spec, rng)
    classes = _assign_classes(spec, rng)
    pools = _assign_pools(spec, rng)
    if spec.horizon_s is not None and times and max(times) > 0:
        scale = spec.horizon_s / max(times)
        times = [t * scale for t in times]
    events = []
    users = [f"u{i}" for i in range(spec.n_users)]
    for i, uid in enumerate(users):
        events.append({"kind": "arrive", "t": _round_t(times[i]),
                       "user": uid, "cls": classes[i],
                       "pool": pools[i]})
    if spec.churn_frac > 0:
        n_churn = int(round(spec.churn_frac * spec.n_users))
        churners = rng.choice(spec.n_users, size=n_churn, replace=False)
        for i in sorted(int(c) for c in churners):
            down = times[i] + float(rng.exponential(spec.churn_delay_s))
            up = down + float(rng.exponential(spec.reconnect_s))
            events.append({"kind": "disconnect", "t": _round_t(down),
                           "user": users[i]})
            events.append({"kind": "reconnect", "t": _round_t(up),
                           "user": users[i]})
    events.sort(key=lambda e: (e["t"], e["user"], e["kind"]))
    meta = {"schema": TRACE_SCHEMA, "kind": "trace_header",
            **_spec_fields(spec)}
    return Trace(meta=meta, events=events)


def _spec_fields(spec: TraceSpec) -> dict:
    d = dataclasses.asdict(spec)
    d["timestamps"] = list(d["timestamps"])
    d["class_mix"] = [[c, w] for c, w in d["class_mix"]]
    d["pool_sizes"] = list(d["pool_sizes"])
    return d


def spec_from_meta(meta: dict) -> TraceSpec:
    """Header line → the spec that generated it (the regeneration pin:
    ``generate(spec_from_meta(t.meta))`` reproduces ``t`` exactly)."""
    fields = {f.name for f in dataclasses.fields(TraceSpec)}
    kw = {k: v for k, v in meta.items() if k in fields}
    kw["timestamps"] = tuple(kw.get("timestamps") or ())
    kw["class_mix"] = tuple((c, w) for c, w in kw.get("class_mix") or ())
    kw["pool_sizes"] = tuple(kw.get("pool_sizes") or ())
    return TraceSpec(**kw)


def to_lines(trace: Trace) -> list:
    """The canonical serialization: header first, then events in their
    sorted order, keys sorted — byte-stable across runs and platforms."""
    lines = [json.dumps(trace.meta, sort_keys=True)]
    lines += [json.dumps(e, sort_keys=True) for e in trace.events]
    return lines


def save(trace: Trace, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(("\n".join(to_lines(trace)) + "\n").encode("utf-8"))
    os.replace(tmp, path)
    return path


def validate_records(records: list) -> list:
    """Grammar validation; returns human-readable error strings (empty =
    valid).  The first line must be a schema-tagged header; every other
    line a known event kind with a numeric non-negative ``t`` and a
    string ``user``; events must be sorted by ``t``; churn events must
    pair (no reconnect without a disconnect before it, and vice versa a
    disconnect must eventually reconnect is NOT required — a trace may
    end with a user away); every churned user must have arrived first."""
    errors = []
    if not records:
        return ["empty trace (no header line)"]
    head = records[0]
    if not isinstance(head, dict) \
            or head.get("kind") != "trace_header":
        errors.append("first line must be the trace_header")
        head = {}
    elif head.get("schema") != TRACE_SCHEMA:
        errors.append(f"header schema must be {TRACE_SCHEMA}, "
                      f"got {head.get('schema')!r}")
    arrived: set = set()
    away: set = set()
    last_t = -1.0
    for i, rec in enumerate(records[1:], 2):
        if not isinstance(rec, dict):
            errors.append(f"line {i}: not an object")
            continue
        kind = rec.get("kind")
        if kind not in EVENT_KINDS:
            errors.append(f"line {i}: unknown event kind {kind!r}")
            continue
        t, user = rec.get("t"), rec.get("user")
        if not isinstance(t, (int, float)) or isinstance(t, bool) \
                or t < 0:
            errors.append(f"line {i}: {kind} needs a numeric t >= 0")
            continue
        if not isinstance(user, str) or not user:
            errors.append(f"line {i}: {kind} needs a string user")
            continue
        if t < last_t:
            errors.append(f"line {i}: events out of order "
                          f"({t} after {last_t})")
        last_t = max(last_t, float(t))
        if kind == "arrive":
            if user in arrived:
                errors.append(f"line {i}: duplicate arrival for {user}")
            if not isinstance(rec.get("cls"), str):
                errors.append(f"line {i}: arrive needs a string cls")
            pool = rec.get("pool")
            if not isinstance(pool, int) or isinstance(pool, bool) \
                    or pool < 1:
                errors.append(f"line {i}: arrive needs a positive int "
                              "pool")
            arrived.add(user)
        elif kind == "disconnect":
            if user not in arrived:
                errors.append(f"line {i}: disconnect before arrival "
                              f"for {user}")
            elif user in away:
                errors.append(f"line {i}: {user} is already away")
            away.add(user)
        else:  # reconnect
            if user not in away:
                errors.append(f"line {i}: reconnect without a "
                              f"disconnect for {user}")
            away.discard(user)
    return errors


def load(path: str) -> Trace:
    """Read + validate a trace file.  Raises ``ValueError`` with every
    grammar error when the file doesn't parse as a trace — a soak must
    never start from a half-understood load shape."""
    records = []
    with open(path, "rb") as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            records.append(json.loads(raw.decode("utf-8")))
    errors = validate_records(records)
    if errors:
        raise ValueError(f"invalid trace {path}: " + "; ".join(errors))
    return Trace(meta=records[0], events=records[1:])


def trace_digest(trace: Trace) -> str:
    """SHA-256 over the canonical serialization — the determinism pin:
    two generations of the same spec, or a save → load round-trip, must
    agree on this digest."""
    h = hashlib.sha256()
    for line in to_lines(trace):
        h.update(line.encode("utf-8"))
        h.update(b"\n")
    return h.hexdigest()
