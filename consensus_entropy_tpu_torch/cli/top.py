"""``top``: the live fleet view over the status snapshots.

Counterpart of ``consensus_entropy_tpu/cli/top.py:1-258``: for the same
snapshots and the same ``now``, :func:`render` gives the JAX package's
frame, character for character.  It reads the ``status_<host>.json``
files the operator plane's writers (``obs.status.StatusWriter``) refresh,
one per serve worker plus the fabric coordinator, and renders per-host
queue depths and live sessions, bucket occupancy, drain and fence state,
planner edges and the active alerts.  A snapshot older than
``STALE_INTERVALS`` times its writer's own ``interval_s`` (``--stale-s``
for snapshots without one) is flagged STALE and dimmed: a wedged, dead or
gray-slow writer looks stale.  Unparseable snapshots are skipped, so
attaching mid-write or mid-copy never crashes the view.

Host code only, no device: point it at a run's ``users/`` directory (or
its ``status/`` directory) wherever the files are visible::

    python -m consensus_entropy_tpu_torch.cli.top models/users
    python -m consensus_entropy_tpu_torch.cli.top models/users --once
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def resolve_status_dir(path: str) -> str:
    """Accept either the ``status/`` directory itself or a ``users/``
    directory containing one."""
    sub = os.path.join(path, "status")
    if os.path.isdir(sub):
        return sub
    return path


#: a snapshot older than this many of its WRITER'S OWN write intervals
#: is stale — the gray-failure cue: a wedged-but-alive writer stops
#: refreshing long before its lease expires, and judging age in units
#: of the writer's advertised cadence (``interval_s`` on the snapshot)
#: beats one fleet-wide ``--stale-s`` when workers write at different
#: rates
STALE_INTERVALS = 3.0


def _age(snap: dict, now: float) -> float | None:
    t = snap.get("t")
    return max(now - t, 0.0) if isinstance(t, (int, float)) else None


def _stale_bound(snap: dict, stale_s: float) -> float:
    """The snapshot's own staleness bound: ``STALE_INTERVALS`` times
    its writer's advertised ``interval_s`` when present (newer
    writers), the fleet-wide ``--stale-s`` fallback otherwise."""
    iv = snap.get("interval_s")
    if isinstance(iv, (int, float)) and not isinstance(iv, bool) \
            and iv > 0:
        return STALE_INTERVALS * float(iv)
    return stale_s


def _is_stale(snap: dict, now: float, stale_s: float) -> bool:
    age = _age(snap, now)
    return age is None or age > _stale_bound(snap, stale_s)


def _fmt_age(age: float | None, stale_s: float) -> str:
    if age is None:
        return "?"
    flag = " STALE" if age > stale_s else ""
    return f"{age:.1f}s{flag}"


def _dim(text: str) -> str:
    """ANSI-dim a stale frame (the flag text stays greppable — the dim
    is the at-a-glance cue, the word STALE the scriptable one)."""
    return f"\x1b[2m{text}\x1b[0m"


def _alert_lines(snap: dict) -> list[str]:
    out = []
    for alert in snap.get("alerts") or []:
        detail = " ".join(f"{k}={v}" for k, v in sorted(alert.items())
                          if k not in ("kind", "key"))
        out.append(f"    ! {alert.get('kind')}: {detail}")
    return out


#: per-host counters the history ring turns into deltas — coordinator
#: frames (left) and worker frames (right) share the tuple; fields a
#: frame lacks are simply omitted from its delta line
DELTA_FIELDS = ("unresolved", "queued", "in_flight", "migrations",
                "queue_total", "live", "users_done", "users_failed",
                "holds")


def _delta_line(ring, host: str) -> str | None:
    """The movement annotation under a frame: ``Δ60s queue:-3 done:+5``
    over the ring's retained window.  None until the ring holds two
    distinct snapshots for the host (no movement measurable yet)."""
    if ring is None:
        return None
    d = ring.deltas(host, DELTA_FIELDS)
    span = d.pop("span_s", None)
    moved = {k: v for k, v in d.items() if v}
    if span is None or not moved:
        return None
    parts = " ".join(f"{k}:{v:+g}" for k, v in sorted(moved.items()))
    return f"    Δ{span:.0f}s {parts}"


def render(snaps: dict, *, now: float, stale_s: float = 10.0,
           ring=None) -> str:
    """One frame of the fleet view (pure function of the snapshots —
    unit-testable; the watch loop just reprints it).  ``ring`` (an
    ``obs.status.HistoryRing`` the watch loop owns) adds per-host
    depth/occupancy delta lines over its retained window."""
    if not snaps:
        return ("cetpu-top: no status snapshots yet (is the run live, "
                "and introspection on?)")
    lines = []
    # the coordinator frame first (it carries the fleet shape)
    coord_keys = [h for h, s in snaps.items() if "hosts" in s]
    for key in sorted(coord_keys):
        s = snaps[key]
        age = _fmt_age(_age(s, now), _stale_bound(s, stale_s))
        head = f"[{key}] fleet — updated {age} ago"
        lines.append(_dim(head) if _is_stale(s, now, stale_s) else head)
        lines.append(
            f"    unresolved={s.get('unresolved')} "
            f"queued={s.get('queued')} in_flight={s.get('in_flight')} "
            f"spawns={s.get('spawns')} joins={s.get('joins')} "
            f"migrations={s.get('migrations')} "
            f"fences={s.get('fences')} drains={s.get('drains')}")
        delta = _delta_line(ring, key)
        if delta:
            lines.append(delta)
        if s.get("edges"):
            lines.append(f"    fleet edges: {s['edges']}")
        if s.get("draining_host"):
            lines.append(f"    draining: {s['draining_host']}")
        if s.get("hold_active"):
            lines.append(f"    ADMISSION HOLD (holds={s.get('holds')})")
        if s.get("parked"):
            lines.append(f"    parked={s.get('parked')} "
                         f"(disconnects={s.get('disconnects')} "
                         f"reconnects={s.get('reconnects')})")
        for hid, hv in sorted((s.get("hosts") or {}).items()):
            state = ("draining" if hv.get("draining")
                     else "live" if hv.get("alive") else "down")
            beat = hv.get("lease_age_s")
            beat = f"{beat:.1f}s" if isinstance(beat, (int, float)) \
                else "-"
            lines.append(f"    {hid:<6} {state:<9} "
                         f"load={hv.get('load')} lease_age={beat}")
        lines.extend(_alert_lines(s))
    # worker frames
    for key in sorted(h for h in snaps if h not in coord_keys):
        s = snaps[key]
        age = _fmt_age(_age(s, now), _stale_bound(s, stale_s))
        stale = _is_stale(s, now, stale_s)
        flags = []
        if s.get("draining"):
            flags.append("DRAINING")
        if not s.get("intake_open", True):
            flags.append("intake-closed")
        if s.get("fences_pending"):
            flags.append(f"fences={s['fences_pending']}")
        queued = s.get("queued") or {}
        qtxt = " ".join(f"{cls}:{n}" for cls, n in sorted(queued.items()))
        head = (
            f"[{key}] live={s.get('live')}/{s.get('target_live')} "
            f"queue={s.get('queue_total')} ({qtxt or '-'}) "
            f"done={s.get('users_done')} failed={s.get('users_failed')}"
            f"{' ' + ' '.join(flags) if flags else ''}"
            f" — updated {age} ago")
        lines.append(_dim(head) if stale else head)
        delta = _delta_line(ring, key)
        if delta:
            lines.append(delta)
        planner = s.get("planner") or {}
        if planner.get("edges"):
            lines.append(f"    edges={planner['edges']} "
                         f"(obs={planner.get('observations')}, "
                         f"holds adm={planner.get('admission_hold_rounds')}"
                         f"/disp={planner.get('dispatch_hold_rounds')})")
        for width, b in sorted((s.get("buckets") or {}).items(),
                               key=lambda kv: int(kv[0])):
            lines.append(f"    bucket {width}: occ={b.get('occupancy')} "
                         f"batch={b.get('mean_batch')} "
                         f"n={b.get('dispatches')}")
        if s.get("breaker"):
            lines.append(f"    breaker: {s['breaker']}")
        lines.extend(_alert_lines(s))
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Live fleet view over the introspection plane's "
                    "status_<host>.json snapshots")
    p.add_argument("status_dir",
                   help="the run's users/ directory (or its status/ "
                        "subdirectory)")
    p.add_argument("--interval", type=float, default=1.0, metavar="S",
                   help="refresh period for the watch loop (default 1)")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit (CI / scripts)")
    p.add_argument("--stale-s", type=float, default=10.0, metavar="S",
                   help="flag snapshots older than this as STALE "
                        "(default 10)")
    p.add_argument("--history", type=int, default=60, metavar="N",
                   help="snapshots retained per host for the Δ movement "
                        "lines in watch mode (default 60)")
    return p


def main(argv=None) -> int:
    from consensus_entropy_tpu_torch.obs.status import (
        HistoryRing,
        read_status_dir,
    )

    args = build_parser().parse_args(argv)
    status_dir = resolve_status_dir(args.status_dir)
    if args.once:
        print(render(read_status_dir(status_dir), now=time.time(),
                     stale_s=args.stale_s))
        return 0
    ring = HistoryRing(depth=args.history)
    try:
        while True:
            snaps = read_status_dir(status_dir)
            ring.push(snaps)
            frame = render(snaps, now=time.time(),
                           stale_s=args.stale_s, ring=ring)
            # clear + home, then the frame: a flicker-free enough watch
            # loop without a curses dependency
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            time.sleep(max(args.interval, 0.1))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
