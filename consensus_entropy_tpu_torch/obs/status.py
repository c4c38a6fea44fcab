"""Per-host live status snapshots: the operator plane's view of what a
serve or fabric run is doing now.

Counterpart of ``consensus_entropy_tpu/obs/status.py:1-219``, with the
same snapshot schema, file name and bytes, so either package's ``top``
reads either package's status directory.  Each serve worker (and the
fabric coordinator) rewrites one small ``status_<host>.json`` through a
tmp file and ``os.replace``, rate-limited, so a reader sees the previous
snapshot or the current one, never a torn file; ``cli/top.py`` renders
the directory as a live fleet view.  :func:`read_status` still returns
``None`` on any parse failure: files get copied around, and network
filesystems break rename atomicity.

The writer takes an injected ``clock=`` (callers in ``serve/`` read no
wall clock themselves), and snapshots are telemetry: nothing journaled or
replayed reads one back, so the plane cannot change results.
"""

from __future__ import annotations

import glob
import json
import os
import time

#: snapshot schema floor: every status file must carry these at these
#: kinds (the same str/int/float vocabulary as the event table)
STATUS_FIELDS = {"kind": "str", "host": "str", "t": "float",
                 "schema": "int"}

#: the snapshot-file schema version (independent of the event stream's)
STATUS_SCHEMA = 1


def status_path(status_dir: str, host: str) -> str:
    return os.path.join(status_dir, f"status_{host}.json")


class StatusWriter:
    """Atomic-rename snapshot writer for one host, rate-limited.

    ``interval_s``: minimum seconds between writes (:meth:`maybe_write`
    is called every loop round; most rounds return without I/O).
    ``clock``: the injected wall clock — snapshots cross processes, so
    wall time is the right axis, and the seam keeps callers clock-free.
    """

    def __init__(self, status_dir: str, host: str, *,
                 interval_s: float = 1.0, clock=time.time):
        if interval_s < 0:
            raise ValueError(f"interval_s must be >= 0, got {interval_s}")
        self.path = status_path(status_dir, host)
        self.host = host
        self.interval_s = interval_s
        self.writes = 0
        #: swallowed best-effort failures (see :meth:`maybe_write`)
        self.errors = 0
        self._clock = clock
        self._last_write: float | None = None

    def maybe_write(self, build) -> bool:
        """Write a fresh snapshot when the interval elapsed; ``build()``
        (a nullary callable returning the payload dict) only runs when a
        write actually happens, so idle rounds cost one clock read.

        BEST-EFFORT: any failure (disk full, network-FS rename error, a
        payload-builder bug) is swallowed and counted — the serve loop
        and the fabric coordinator call this inline, and the
        introspection plane must never take down the fleet it observes
        (:meth:`write` itself still raises, for callers that want the
        error)."""
        now = self._clock()
        if self._last_write is not None \
                and now - self._last_write < self.interval_s:
            return False
        try:
            self.write(build())
        except Exception:
            self.errors += 1
            self._last_write = now  # don't retry at poll rate
            return False
        return True

    def write(self, payload: dict) -> dict:
        """One snapshot: payload + the schema floor (kind/host/t) +
        this writer's ``interval_s`` (so a READER can judge staleness
        in units of the writer's own cadence — ``top`` flags a
        snapshot older than a few write intervals without the operator
        re-deriving the fleet's ``--status-interval``), then tmp-write
        + ``os.replace`` so readers never see a torn file."""
        now = self._clock()
        snap = {"schema": STATUS_SCHEMA, "kind": "status",
                "host": self.host, "t": round(now, 3),
                "interval_s": self.interval_s, **payload}
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = f"{self.path}.tmp"
        with open(tmp, "wb") as f:
            f.write(json.dumps(snap).encode("utf-8"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._last_write = now
        self.writes += 1
        return snap


def read_status(path: str) -> dict | None:
    """One snapshot, or ``None`` for missing/torn/non-dict files — the
    reader half of the torn-read tolerance contract (the atomic rename
    makes tears rare; copies and network filesystems make them
    possible)."""
    try:
        with open(path, "rb") as f:
            rec = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError, UnicodeDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


def read_status_dir(status_dir: str) -> dict[str, dict]:
    """``{host: snapshot}`` over every readable ``status_*.json`` in the
    directory (unreadable ones skipped, per the tolerance contract)."""
    out: dict[str, dict] = {}
    for path in sorted(glob.glob(status_path(status_dir, "*"))):
        snap = read_status(path)
        if snap is None:
            continue
        base = os.path.basename(path)
        host = base[len("status_"):-len(".json")]
        out[snap.get("host") or host] = snap
    return out


class HistoryRing:
    """The last-N snapshots per host: ``top``'s watch loop pushes each
    poll's snapshots here and renders depth/occupancy DELTAS against the
    ring, so a soak is watchable as movement — queue draining or
    building, users finishing — not just absolute numbers.  Pure
    in-memory bookkeeping: snapshots are telemetry, nothing replayed
    reads them.

    A host's snapshot only enters the ring when its ``t`` advanced (the
    writer is rate-limited; re-reading an unchanged file must not
    flatten the deltas to zero)."""

    def __init__(self, depth: int = 60):
        if depth < 2:
            raise ValueError(f"depth must be >= 2, got {depth}")
        self.depth = depth
        self._ring: dict[str, list] = {}

    def push(self, snaps: dict) -> None:
        """Fold one ``read_status_dir`` result in (stale/unchanged
        snapshots — same ``t`` as the host's newest entry — are
        skipped)."""
        for host, snap in snaps.items():
            dq = self._ring.setdefault(host, [])
            if dq and dq[-1].get("t") == snap.get("t"):
                continue
            dq.append(snap)
            del dq[:-self.depth]

    def history(self, host: str) -> list:
        """Oldest → newest retained snapshots for one host."""
        return list(self._ring.get(host, ()))

    def deltas(self, host: str, fields: tuple) -> dict:
        """``{field: newest - oldest}`` over the retained window for
        the numeric ``fields`` present at both ends (missing or
        non-numeric at either end → field omitted), plus ``span_s`` —
        the window's wall span.  One entry in the ring → empty dict (no
        movement measurable yet)."""
        hist = self._ring.get(host, ())
        if len(hist) < 2:
            return {}
        lo, hi = hist[0], hist[-1]
        out = {}
        for f in fields:
            a, b = lo.get(f), hi.get(f)
            if isinstance(a, (int, float)) and not isinstance(a, bool) \
                    and isinstance(b, (int, float)) \
                    and not isinstance(b, bool):
                out[f] = b - a
        if out and isinstance(lo.get("t"), (int, float)) \
                and isinstance(hi.get("t"), (int, float)):
            out["span_s"] = round(hi["t"] - lo["t"], 3)
        return out


def validate_status(snap: dict) -> list[str]:
    """Schema-floor validation for one snapshot (run on mid-run
    snapshots); returns error strings, empty = valid."""
    from consensus_entropy_tpu_torch.obs.export import FIELD_KINDS

    errors = []
    for field, kind in STATUS_FIELDS.items():
        if field not in snap:
            errors.append(f"status snapshot lacks {field!r}")
        elif not FIELD_KINDS[kind](snap[field]):
            errors.append(f"status field {field!r} must be {kind}, "
                          f"got {snap[field]!r}")
    if not errors and snap.get("kind") != "status":
        errors.append(f"kind must be 'status', got {snap.get('kind')!r}")
    alerts = snap.get("alerts")
    if alerts is not None and not (
            isinstance(alerts, list)
            and all(isinstance(a, dict) and isinstance(a.get("kind"), str)
                    for a in alerts)):
        errors.append("alerts must be a list of {kind: str, ...} dicts")
    return errors
