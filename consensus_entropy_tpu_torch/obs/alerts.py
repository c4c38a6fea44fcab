"""SLO burn-rate alerts: pure-function watchers over telemetry the
stack already records.

The serving stack KNOWS when it is in trouble — the planner tracks
per-class SLO headroom, the queue knows how long its batch head has
aged, the breaker knows which widths are degraded, the coordinator knows
which leases are about to expire.  Each kernel here is a pure
function of observed telemetry (injected ``now``, unit-testable to the
boundary), and :class:`AlertWatcher` edge-triggers the schema-registered
``alert`` event (``obs.export.EVENT_FIELDS``) when an alert RISES —
re-evaluations while it stays active are silent, so a wedged fleet
doesn't flood its own metrics stream.

Counterpart of ``consensus_entropy_tpu/obs/alerts.py``.  Alerts change
when operators look, never results: nothing journaled or replayed reads
an alert.

Alert kinds:

- ``slo_headroom`` — a priority class's p95 admission→finish latency has
  burned past ``burn_frac`` of its SLO target: the tail is about to
  breach, before it actually does.
- ``batch_aging`` — the queue's batch-class head has waited past the
  aging bound: strict priority is starving throughput work and the aging
  guard is doing real work.
- ``breaker_open`` — a bucket width is degraded to per-user dispatch
  (open or spent breaker): stacked throughput is gone on that width.
- ``lease_expiry`` — a worker's lease age has burned past ``burn_frac``
  of the lease: the host is about to be declared dead and failed over.
- ``placement_skew`` — a live host's unresolved load sits more than
  ``max_skew`` above the fleet's floor: the placement invariant is being
  violated by attrition or degradation, and the remediation plane's
  drain-for-rebalance (``serve.remedy``) is the journaled response.
- ``gray_suspect`` — a host is SLOW relative to its peers without being
  dead: one or more gray signals (journal-append age, feed-ack lag,
  lease-age skew, step-wall EMA) sit at ``gray_ratio`` times the peer
  median AND past an absolute floor.  Peer-RELATIVE on purpose: a
  constant threshold either fires on every cold start or sleeps through
  a 10x-slow host on a fast fleet.  The coordinator's gray ladder
  (``serve.remedy``) is the journaled response.

Alerts can also ROUTE: :class:`AlertWatcher` takes a tuple of SINKS
(:class:`ConsoleSink` — operator log line, :class:`JsonlSink` —
append-only ``alerts.jsonl`` for ``tail -f``, :class:`CommandSink` —
webhook-shaped command invocation per alert; build from a CLI spec with
:func:`make_sink`), each fed every RISEN alert.  Sinks are telemetry
delivery, never control flow: a raising sink is counted
(``sink_errors``) and skipped, and no journaled decision reads one.
"""

from __future__ import annotations

ALERT_KINDS = ("slo_headroom", "batch_aging", "breaker_open",
               "lease_expiry", "placement_skew", "gray_suspect")

#: default fraction of a bound an observation may burn before alerting
BURN_FRAC = 0.8

#: gray-failure outlier gates: a host is suspect when its signal is at
#: least ``GRAY_RATIO`` times the PEER MEDIAN (the median of the OTHER
#: hosts — a fleet-wide slowdown is load, not a gray failure) AND at
#: least ``GRAY_MIN_ABS_S`` in absolute terms (ratio alone would flag
#: microsecond noise on an idle fleet)
GRAY_RATIO = 3.0
GRAY_MIN_ABS_S = 1.0


def slo_headroom_alerts(per_class_p95: dict, slo_s: dict, *,
                        burn_frac: float = BURN_FRAC) -> list[dict]:
    """``per_class_p95``: observed p95 admission→finish latency per
    priority class; ``slo_s``: the per-class targets.  Fires per class
    whose p95 burned past ``burn_frac`` of its target."""
    out = []
    for cls in sorted(per_class_p95):
        p95, target = per_class_p95[cls], slo_s.get(cls)
        if p95 is None or not target or target <= 0:
            continue
        if p95 >= burn_frac * target:
            out.append({"kind": "slo_headroom", "key": cls, "cls": cls,
                        "p95_s": round(float(p95), 4),
                        "slo_s": float(target),
                        "burn": round(float(p95) / target, 4)})
    return out


def batch_aging_alerts(head_waits: dict, aging_s: float) -> list[dict]:
    """``head_waits``: seconds each non-empty queue class's head entry
    has waited (``AdmissionQueue.head_waits``).  Fires per non-top class
    whose head aged past the bound (aging 0 = guard off, never fires)."""
    if not aging_s or aging_s <= 0:
        return []
    out = []
    for cls in sorted(head_waits):
        if cls == "interactive":
            continue  # the top class never ages past itself
        wait = head_waits[cls]
        if wait is not None and wait >= aging_s:
            out.append({"kind": "batch_aging", "key": cls, "cls": cls,
                        "head_wait_s": round(float(wait), 4),
                        "aging_s": float(aging_s)})
    return out


def breaker_alerts(breaker_states: dict | None) -> list[dict]:
    """``breaker_states``: ``{width: state}`` from
    ``DispatchBreaker.summary`` — which also lists CLOSED widths that
    merely have recent failures, so closed entries are skipped here:
    only a width actually degraded to per-user dispatch (open /
    half_open probing / given up) alerts."""
    out = []
    for width, state in sorted((breaker_states or {}).items()):
        if str(state) == "closed":
            continue  # failures counted, but stacked dispatch intact
        out.append({"kind": "breaker_open", "key": str(width),
                    "width": int(width), "state": str(state)})
    return out


def lease_alerts(lease_ages: dict, lease_s: float, *,
                 burn_frac: float = BURN_FRAC) -> list[dict]:
    """``lease_ages``: seconds since each live host's last heartbeat
    (``None`` = never beat yet, not alertable — spawn grace owns that).
    Fires per host whose age burned past ``burn_frac`` of the lease."""
    if not lease_s or lease_s <= 0:
        return []
    out = []
    for host in sorted(lease_ages):
        age = lease_ages[host]
        if age is not None and age >= burn_frac * lease_s:
            out.append({"kind": "lease_expiry", "key": str(host),
                        "host": str(host),
                        "age_s": round(float(age), 4),
                        "lease_s": float(lease_s)})
    return out


def skew_alerts(loads: dict, *, max_skew: int) -> list[dict]:
    """``loads``: unresolved-user count per live, non-draining host
    (journal-replayed — the same view ``serve.placement`` places by).
    Fires per host whose load sits MORE than ``max_skew`` above the
    fleet's floor (the least-loaded host) — the exact complement of the
    placement rule, which only admits onto hosts within the skew bound,
    so a firing alert means attrition or degradation broke an invariant
    placement alone cannot restore.  A one-host fleet has no skew."""
    if len(loads) < 2:
        return []
    floor = min(loads.values())
    out = []
    for host in sorted(loads):
        load = loads[host]
        if load - floor > max_skew:
            out.append({"kind": "placement_skew", "key": str(host),
                        "host": str(host), "load": int(load),
                        "floor": int(floor), "max_skew": int(max_skew)})
    return out


def _median(vals: list) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return float(s[mid]) if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def _gray_outliers(values: dict, *, ratio: float,
                   min_abs_s: float) -> list[tuple]:
    """The peer-relative outlier kernel shared by every gray signal:
    ``values`` maps host -> observed seconds (``None`` = no observation,
    excluded from both sides).  For each host the PEER baseline is the
    median of the OTHER hosts' values — excluding self, so one sick host
    cannot drag the baseline toward itself on a small fleet.  Fires
    ``(host, value, peer_median)`` when the value clears BOTH gates (see
    ``GRAY_RATIO`` / ``GRAY_MIN_ABS_S``) and strictly exceeds its peers
    (a fleet that is uniformly slow is load, not gray).  Fewer than two
    observed hosts → no peers → no outliers."""
    obs = {h: float(v) for h, v in values.items() if v is not None}
    if len(obs) < 2:
        return []
    out = []
    for host in sorted(obs):
        peers = [v for h, v in obs.items() if h != host]
        peer = _median(peers)
        v = obs[host]
        if v >= min_abs_s and v >= ratio * max(peer, 0.0) and v > peer:
            out.append((host, v, peer))
    return out


def gray_suspect_alerts(*, append_ages: dict | None = None,
                        ack_lags: dict | None = None,
                        lease_ages: dict | None = None,
                        step_walls: dict | None = None,
                        ratio: float = GRAY_RATIO,
                        min_abs_s: float = GRAY_MIN_ABS_S) -> list[dict]:
    """The gray-failure detector: four peer-relative signals, one alert
    per suspect host with the evidence attached.

    - ``append_ages``: seconds since each LOADED host's event journal
      last grew (an idle host legitimately appends nothing — callers
      must pass only hosts with unresolved users).
    - ``ack_lags``: age of each host's oldest unacked fence/drop
      (``0.0`` — not ``None`` — for hosts with nothing pending, so only
      a genuinely lagging host skews against its peers).
    - ``lease_ages``: seconds since each host's last heartbeat (the
      same view ``lease_alerts`` reads — gray catches the host whose
      beats land LATE but never late enough to expire the lease).
    - ``step_walls``: each host's self-advertised dispatch step-wall
      EMA (``step_ema_s`` on its lease record).

    Each signal runs :func:`_gray_outliers` independently; a host
    flagged by ANY signal gets one ``gray_suspect`` alert listing every
    firing signal plus its value/peer pair — the evidence the ladder
    journals and the operator reads."""
    signals = (("append_age", append_ages), ("ack_lag", ack_lags),
               ("lease_age", lease_ages), ("step_wall", step_walls))
    by_host: dict[str, dict] = {}
    for name, values in signals:
        if not values:
            continue
        for host, v, peer in _gray_outliers(values, ratio=ratio,
                                            min_abs_s=min_abs_s):
            alert = by_host.setdefault(
                str(host), {"kind": "gray_suspect", "key": str(host),
                            "host": str(host), "signals": []})
            alert["signals"].append(name)
            alert[f"{name}_s"] = round(float(v), 4)
            alert[f"{name}_peer_s"] = round(float(peer), 4)
    return [by_host[h] for h in sorted(by_host)]


class ConsoleSink:
    """Operator console delivery: one human log line per risen alert.
    ``write`` defaults to ``print`` (the CLI passes its own logger)."""

    def __init__(self, write=None):
        self._write = write if write is not None else print

    def emit(self, alert: dict) -> None:
        detail = " ".join(f"{k}={v}" for k, v in sorted(alert.items())
                          if k not in ("kind", "key"))
        self._write(f"ALERT [{alert.get('kind')}] {detail}")


class JsonlSink:
    """Append-only JSONL alert log (the ``tail -f`` surface): one JSON
    line per risen alert, flushed per emit so a follower sees it
    promptly.  Telemetry, not a ledger — no fsync, no lock."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def emit(self, alert: dict) -> None:
        import json
        import os

        if self._f is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._f = open(self.path, "ab")
        self._f.write((json.dumps(alert) + "\n").encode("utf-8"))
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class CommandSink:
    """Webhook-shaped delivery without a network dependency: run
    ``argv + [json-encoded alert]`` per risen alert (a curl wrapper, a
    pager script, a chat-post hook).  Bounded by ``timeout_s`` and
    fire-and-forget — a failing or hanging command is the WATCHER's
    problem to count, never the serve loop's to wait on."""

    def __init__(self, argv: list, *, timeout_s: float = 5.0):
        if not argv:
            raise ValueError("CommandSink needs a non-empty argv")
        self.argv = [str(a) for a in argv]
        self.timeout_s = timeout_s

    def emit(self, alert: dict) -> None:
        import json
        import subprocess

        subprocess.run(self.argv + [json.dumps(alert)],
                       check=True, timeout=self.timeout_s,
                       stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL)


def make_sink(spec: str, *, log=None):
    """Build one sink from its CLI spec (``--alert-sink``, repeatable):
    ``console`` | ``jsonl:<path>`` | ``cmd:<shell-words>``.  Unknown
    kinds and missing arguments fail HERE at construction (the
    validate-at-the-edge precedent), not as a silently-dropped alert."""
    kind, _, arg = str(spec).partition(":")
    if kind == "console":
        return ConsoleSink(log)
    if kind == "jsonl":
        if not arg:
            raise ValueError("jsonl sink needs a path: jsonl:<path>")
        return JsonlSink(arg)
    if kind == "cmd":
        if not arg:
            raise ValueError("cmd sink needs a command: cmd:<command>")
        import shlex

        return CommandSink(shlex.split(arg))
    raise ValueError(f"unknown alert sink {spec!r} "
                     "(choose console | jsonl:<path> | cmd:<command>)")


class AlertWatcher:
    """Edge-triggered alert surface: :meth:`update` takes the round's
    full evaluated alert list, emits a schema ``alert`` event (plus an
    operator log line via ``log``) for each NEWLY-risen ``(kind, key)``,
    and keeps the active set for snapshots.  An alert that stops holding
    simply leaves the active set — re-rising re-emits.

    ``sinks``: delivery fan-out (see :func:`make_sink`) — each risen
    alert goes to every sink; a raising sink increments ``sink_errors``
    and is skipped for that alert (delivery is telemetry, never control
    flow).

    Edge-triggering is SNAPSHOT-based, so a condition that clears and
    re-rises BETWEEN two :meth:`update` calls looks continuously active
    and the second rise would be silently coalesced into the first.
    Whoever CLEARS a condition mid-interval (the remediation plane,
    after acting on an alert) must call :meth:`rearm` so the next
    evaluation re-fires if the condition still — or again — holds."""

    def __init__(self, report=None, *, log=None, sinks=()):
        self.report = report
        self.log = log
        self.sinks = tuple(sinks)
        self.fired = 0
        self.sink_errors = 0
        #: (kind, key) -> the alert dict, as currently active
        self._active: dict[tuple, dict] = {}

    def update(self, alerts: list[dict]) -> list[dict]:
        """Fold one evaluation round; returns the alerts that ROSE."""
        now_keys = set()
        rose = []
        for alert in alerts:
            key = (alert.get("kind"), alert.get("key"))
            now_keys.add(key)
            if key not in self._active:
                rose.append(alert)
            self._active[key] = alert
        for key in list(self._active):
            if key not in now_keys:
                del self._active[key]
        for alert in rose:
            self.fired += 1
            if self.report is not None:
                fields = {k: v for k, v in alert.items() if k != "key"}
                self.report.event("alert", **fields)
            if self.log is not None:
                detail = " ".join(f"{k}={v}" for k, v in
                                  sorted(alert.items())
                                  if k not in ("kind", "key"))
                self.log(f"ALERT [{alert.get('kind')}] {detail}")
            for sink in self.sinks:
                try:
                    sink.emit(alert)
                except Exception:
                    # a broken pager script must never wedge the serve
                    # loop — count it and keep the round going
                    self.sink_errors += 1
        return rose

    def rearm(self, kind: str, key=None) -> None:
        """Drop ``(kind, key)`` — or every key of ``kind`` when ``key``
        is ``None`` — from the active set, so the NEXT evaluation round
        re-emits the alert if its condition still (or again) holds.

        The edge-trigger REARM (this PR's watcher bugfix): a remediation
        that clears a condition mid-poll-interval would otherwise leave
        the stale entry active, and a re-risen condition inside the same
        interval would be coalesced into the original edge — the second
        ``alert`` event never fired.  Acting on an alert consumes it."""
        if key is None:
            for k in list(self._active):
                if k[0] == kind:
                    del self._active[k]
        else:
            self._active.pop((kind, key), None)

    @property
    def active(self) -> list[dict]:
        """The currently-active alerts (snapshot surface), stable
        order."""
        return [self._active[k] for k in sorted(self._active,
                                                key=lambda kv: (str(kv[0]),
                                                                str(kv[1])))]
