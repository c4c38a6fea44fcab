"""Readers, schema validation, the span merge, Chrome trace export and
the text report.

Counterpart of ``consensus_entropy_tpu/obs/export.py`` (``:1-550``), pure
host code (json and os): the same event table, the same validation
messages and the same Chrome trace for the same records.

Chrome trace output loads in Perfetto (or ``chrome://tracing``): one
process lane per host, one thread lane per user, bucket or run within it,
and a ``control-plane`` process for the ``ctl.*`` decisions.  The span
merge dedupes by the deterministic span id, keeping the longest duration
(a partially written eviction span loses to the completed re-run).
:func:`alert_counts` counts the ``alert`` events the watchers of
``obs.alerts`` emit, by kind, across every host's stream.
"""

from __future__ import annotations

import glob
import os

#: schema-v2 event table: event kind -> ``{field: kind}`` — the fields
#: every record of that kind must carry (beyond ``schema``/``event``;
#: ``t_s`` is required for all but the summary records, which close a
#: stream rather than timestamp a transition) AND the value kind each
#: must hold.  Kinds: ``str`` / ``int`` (bools excluded) / ``float``
#: (ints accepted — JSON round-trips may narrow) / ``list``.  The table
#: is the JAX package's whole (fabric events included), so a stream of
#: either package validates the same.
EVENT_FIELDS = {
    # admission flow (enqueue/admit also carry a ``cls`` priority-class
    # field since the SLO planner — OPTIONAL here so pre-planner v2
    # streams keep validating)
    "enqueue": {"user": "str", "depth": "int"},
    "admit": {"user": "str", "width": "int", "wait_s": "float",
              "depth": "int", "live": "int"},
    "user_done": {"user": "str"},
    "user_failed": {"user": "str", "error": "str"},
    "skip_done": {"user": "str"},
    "skip_poisoned": {"user": "str"},
    # engine lifecycle
    "evict": {"user": "str", "error": "str"},
    "resume": {"user": "str", "attempt": "int"},
    "watchdog_evict": {"user": "str"},
    "dispatch_failed": {"fn": "str", "width": "int"},
    "dispatch_session_error": {"user": "str", "fn": "str"},
    # fault domain
    "breaker_open": {"width": "int"},
    "breaker_close": {"width": "int"},
    "breaker_probe": {"width": "int"},
    "breaker_giveup": {"width": "int"},
    "requeue": {"user": "str", "attempt": "int"},
    "requeue_reload_failed": {"user": "str"},
    "poison": {"user": "str"},
    "drain": {},
    "journal_recover": {},
    # SLO planner decisions (serve.planner)
    "planner_edges": {"edges": "list"},
    "admission_hold": {"window_s": "float"},
    # the JAX package's jit-compile events: the port compiles nothing at
    # run time and emits none; the entry keeps the two schemas equal, so
    # either package's validator reads the other's streams
    "compile": {"fn": "str", "build_s": "float"},
    # SLO burn-rate alerts (obs.alerts): edge-triggered operator signals
    "alert": {"kind": "str"},
    # fabric
    "assign": {"user": "str", "host": "str"},
    "host_up": {"host": "str"},
    "host_down": {"host": "str"},
    "orphan_reaped": {"host": "str"},
    "drain_kill": {"host": "str"},
    "user_finished": {"user": "str"},
    "user_poisoned": {"user": "str"},
    "user_failed_final": {"user": "str"},
    # elastic control plane (serve.elastic / serve.placement)
    "host_spawn": {"host": "str"},
    "host_join": {"host": "str"},
    "host_adopt": {"host": "str"},
    "host_adopt_refused": {"host": "str"},
    "migrate_request": {"user": "str", "host": "str"},
    "migrate": {"user": "str", "host": "str"},
    "migrate_refused": {"user": "str"},
    "withdraw": {"user": "str"},
    "fleet_edges": {"edges": "list"},
    # graceful scale-down + checkpoint-fenced live migration
    "host_drain": {"host": "str"},
    "drain_done": {"host": "str"},
    "migrate_fence": {"user": "str", "host": "str"},
    "migrate_inflight": {"user": "str", "host": "str"},
    "fence_release": {"user": "str"},
    # the remediation plane (serve.remedy): a journaled self-healing
    # decision (drain-for-rebalance / deadline fallback) and the fence
    # that burned past --fence-deadline-s into evict+resume
    "remedy": {"host": "str", "action": "str"},
    "fence_timeout": {"user": "str", "host": "str"},
    # the gray-failure ladder (serve.remedy gray kernels): a host placed
    # on / lifted from probation (placement stops/resumes routing NEW
    # users to it — journaled, so the rung survives a coordinator kill),
    # and a probation host's committee scoring depth dialed between
    # ``full`` and ``cheap`` under sustained SLO burn
    "probation": {"host": "str"},
    "depth_change": {"host": "str", "depth": "str"},
    # live intake churn (workload traces): a producer disconnected a
    # user mid-run (parked; workspace kept) / reconnected it (resumes
    # from the workspace over the journal re-admission path)
    "disconnect": {"user": "str"},
    "reconnect": {"user": "str"},
    # storage integrity (resilience.io + fencing epochs): an injected or
    # real disk fault surfaced through the io seam; a corrupt WAL record
    # CRC-quarantined to its sidecar; a coordinator incarnation claiming
    # its fencing epoch; a stale incarnation's feed line or ack refused
    # (epoch_fenced also carries ``user`` when the line named one)
    "io_fault": {"kind": "str", "path": "str"},
    "record_quarantined": {"host": "str", "path": "str"},
    "epoch_claim": {"epoch": "int"},
    "epoch_fenced": {"host": "str", "epoch": "int"},
    # stream-closing summaries (no t_s)
    "fleet_summary": {},
    "fabric_summary": {},
}

#: the value check per field kind.  ``float`` accepts ints (a JSON
#: round-trip of ``1.0`` may come back ``1``); bools are never ints
#: here (``json.dumps(True)`` is not a count).
FIELD_KINDS = {
    "str": lambda v: isinstance(v, str),
    "int": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "float": lambda v: (isinstance(v, (int, float))
                        and not isinstance(v, bool)),
    "list": lambda v: isinstance(v, list),
}

#: events that close a stream instead of timestamping a transition
_SUMMARY_EVENTS = ("fleet_summary", "fabric_summary")


def read_jsonl_tolerant(path: str) -> list[dict]:
    """Read a JSONL telemetry file, SKIPPING a torn tail line (the
    expected SIGKILL artifact — the same discipline ``serve.journal``
    applies to its WALs) and any other unparseable line, instead of
    raising.  Non-dict lines are dropped too.  CRC-framed journal lines
    (``w1 <crc> {...}``, the storage-integrity format) are unframed
    transparently — a frame failing its CRC is skipped like any other
    corrupt line, because these readers OBSERVE; only replay halts."""
    from consensus_entropy_tpu_torch.resilience import io as dio
    out: list[dict] = []
    if not os.path.exists(path):
        return out
    with open(path, "rb") as f:
        for raw in f:
            status, rec = dio.parse_frame(raw)
            if status == "corrupt":
                continue  # torn/corrupt line: telemetry, not a ledger
            if isinstance(rec, dict) and not dio.is_header(rec):
                out.append(rec)
    return out


def find_metrics_files(users_dir: str) -> list[str]:
    """``fleet_metrics.jsonl`` plus the per-host
    ``fleet_metrics_<h>.jsonl`` files a fabric run leaves."""
    return sorted(glob.glob(os.path.join(users_dir,
                                         "fleet_metrics*.jsonl")))


def find_span_files(users_dir: str) -> list[str]:
    """``spans.jsonl`` (single-host, or the coordinator's transcription)
    plus any per-worker ``fabric/spans_<h>.jsonl`` WALs."""
    return sorted(
        glob.glob(os.path.join(users_dir, "spans*.jsonl"))
        + glob.glob(os.path.join(users_dir, "fabric", "spans_*.jsonl")))


def validate_metrics(records: list[dict], *, path: str = "") -> list[str]:
    """Schema-v2 validation; returns human-readable error strings (empty
    = valid).  Every line must be a tagged dict with a known event, that
    event's required fields AT their registered kinds (the per-field
    type check the v2.1 table added), and — for non-summary events — a
    numeric ``t_s``.
    """
    errors = []
    where = f"{path}:" if path else "line "
    for i, rec in enumerate(records, 1):
        ev = rec.get("event")
        if rec.get("schema") != 2:
            errors.append(f"{where}{i}: missing/wrong schema tag "
                          f"(want 2, got {rec.get('schema')!r})")
            continue
        if ev not in EVENT_FIELDS:
            errors.append(f"{where}{i}: unknown event {ev!r}")
            continue
        if ev not in _SUMMARY_EVENTS \
                and not isinstance(rec.get("t_s"), (int, float)):
            errors.append(f"{where}{i}: event {ev!r} lacks numeric t_s")
        for field, kind in EVENT_FIELDS[ev].items():
            if field not in rec:
                errors.append(f"{where}{i}: event {ev!r} lacks {field!r}")
            elif not FIELD_KINDS[kind](rec[field]):
                errors.append(
                    f"{where}{i}: event {ev!r} field {field!r} must be "
                    f"{kind}, got {rec[field]!r}")
    return errors


def validate_metrics_file(path: str) -> list[str]:
    return validate_metrics(read_jsonl_tolerant(path), path=path)


def load_spans(paths: list[str]) -> list[dict]:
    """Merge span files into one deduped timeline, sorted by ``t0``.
    Dedupe key is the deterministic ``(trace, span)`` id; the longest
    duration wins (see module docstring)."""
    best: dict[tuple, dict] = {}
    for path in paths:
        for rec in read_jsonl_tolerant(path):
            if rec.get("ev") != "span":
                continue
            key = (rec.get("trace"), rec.get("span"))
            prev = best.get(key)
            if prev is None or (rec.get("dur_s") or 0) \
                    > (prev.get("dur_s") or 0):
                best[key] = rec
    return sorted(best.values(), key=lambda r: (r.get("t0") or 0))


def orphan_spans(spans: list[dict]) -> list[dict]:
    """Spans whose ``parent`` id is absent from the merged set — the
    determinism contract says a healthy (resumed-to-completion) run has
    none."""
    ids = {r.get("span") for r in spans}
    return [r for r in spans
            if r.get("parent") is not None and r["parent"] not in ids]


def _lane_of(rec: dict) -> str:
    """The Chrome-trace thread lane: users own their session spans,
    stacked device work rides per-bucket lanes, the run span its own."""
    name = rec.get("name")
    if name == "run":
        return "run"
    if rec.get("user") is not None:
        return f"user {rec['user']}"
    if name in ("score_dispatch", "retrain"):
        width = rec.get("width")
        return f"bucket {width}" if width is not None else "dispatch"
    return "dispatch"


def _flow_id(rec: dict) -> int:
    """Deterministic Chrome flow-event id for a control span (derived
    from the span's own deterministic id, so re-exports and kill+replay
    merges draw the same arrows)."""
    import hashlib

    h = hashlib.sha1(f"flow:{rec.get('trace')}:{rec.get('span')}"
                     .encode("utf-8"))
    return int.from_bytes(h.digest()[:6], "big")


def chrome_trace(spans: list[dict]) -> dict:
    """Render merged spans as Chrome trace-event JSON (Perfetto-loadable):
    complete (``ph: "X"``) events on one process per host — plus a
    dedicated ``control-plane`` process whose thread lanes are the
    ``ctl.*`` decision kinds — and one thread per user/bucket/run lane,
    with metadata naming events.  Control spans carrying ``flow_user``
    additionally emit a Chrome flow pair (``ph: "s"`` at the decision,
    ``ph: "f"`` binding into the user's root span), so a fence/migrate
    decision visibly threads into the session it moved."""
    pids: dict[str, int] = {}
    tids: dict[tuple, int] = {}
    events = []
    #: user -> that user's root-span placement (filled as lanes are
    #: assigned; flow arrows bind to it)
    user_slice: dict[str, dict] = {}
    flows = []

    def lane_for(pkey: str, pname: str, lane: str) -> tuple:
        if pkey not in pids:
            pids[pkey] = len(pids) + 1
            events.append({"name": "process_name", "ph": "M",
                           "pid": pids[pkey], "tid": 0,
                           "args": {"name": pname}})
        tkey = (pkey, lane)
        if tkey not in tids:
            tids[tkey] = len(tids) + 1
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pids[pkey], "tid": tids[tkey],
                           "args": {"name": lane}})
        return pids[pkey], tids[tkey]

    for rec in spans:
        host = rec.get("host") or "local"
        if rec.get("ctl"):
            # the control-plane lane: one process, one thread per
            # decision kind (instant spans of one kind never nest)
            pid, tid = lane_for("__ctl__", "control-plane",
                                rec.get("name") or "ctl")
        else:
            pid, tid = lane_for(host, f"host {host}", _lane_of(rec))
        args = {k: v for k, v in rec.items()
                if k not in ("ev", "name", "t0", "dur_s", "host")}
        ts = int(round((rec.get("t0") or 0) * 1e6))
        dur = max(int(round((rec.get("dur_s") or 0) * 1e6)), 1)
        events.append({
            "name": rec.get("name") or "span", "cat": "obs", "ph": "X",
            "ts": ts, "dur": dur, "pid": pid, "tid": tid, "args": args,
        })
        user = rec.get("user")
        if user is not None and not rec.get("ctl"):
            best = user_slice.get(str(user))
            # the user ROOT span is the flow anchor; any other span of
            # the user's stands in when the root never closed
            if best is None or (rec.get("name") == "user"
                                and best["name"] != "user"):
                user_slice[str(user)] = {"name": rec.get("name"),
                                         "pid": pid, "tid": tid,
                                         "ts": ts, "dur": dur}
        if rec.get("flow_user") is not None:
            flows.append((rec, pid, tid, ts))
    for rec, pid, tid, ts in flows:
        target = user_slice.get(str(rec["flow_user"]))
        if target is None:
            continue  # the user never traced (e.g. --no-trace worker)
        fid = _flow_id(rec)
        name = f"{rec.get('name') or 'ctl'} → {rec['flow_user']}"
        events.append({"name": name, "cat": "obs.flow", "ph": "s",
                       "id": fid, "pid": pid, "tid": tid, "ts": ts})
        # bind the arrow INSIDE the user slice (Chrome attaches flow
        # ends to the enclosing slice at that instant)
        t_end = min(max(ts + 1, target["ts"]),
                    target["ts"] + target["dur"])
        events.append({"name": name, "cat": "obs.flow", "ph": "f",
                       "bp": "e", "id": fid, "pid": target["pid"],
                       "tid": target["tid"], "ts": t_end})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _host_of_metrics_path(path: str) -> str:
    base = os.path.basename(path)
    if base == "fleet_metrics.jsonl":
        return "main"
    return base[len("fleet_metrics_"):-len(".jsonl")] or "main"


def merged_summary(users_dir: str) -> dict:
    """One fleet view over every host's metrics stream: the last
    ``fleet_summary`` per file, keyed by host, plus fleet-wide roll-ups
    (users done/failed, admission→finish latency per host — the fabric
    shape of the SLO telemetry)."""
    per_host = {}
    for path in find_metrics_files(users_dir):
        recs = read_jsonl_tolerant(path)
        summaries = [r for r in recs if r.get("event") == "fleet_summary"]
        if not summaries:
            continue
        per_host[_host_of_metrics_path(path)] = summaries[-1]
    out = {
        "hosts": sorted(per_host),
        "users_done": sum(s.get("users_done") or 0
                          for s in per_host.values()),
        "users_failed": sum(s.get("users_failed") or 0
                            for s in per_host.values()),
        "per_host": per_host,
        "admission_to_finish_s": {
            h: s["admission_to_finish_s"] for h, s in per_host.items()
            if s.get("admission_to_finish_s") is not None},
        "per_class": {
            h: s["per_class"] for h, s in per_host.items()
            if s.get("per_class") is not None},
    }
    return out


def planner_timeline(users_dir: str) -> dict:
    """The SLO planner's decision history: per-host ``planner_edges``
    events (locally derived edges over time), per-host ``fleet_edges``
    events (coordinator broadcasts the host ADOPTED), the
    ``admission_hold`` counts, and — the piece the per-worker streams
    cannot carry — the main journal's own ``planner`` epochs, which in
    fabric mode are the coordinator ``FleetPlanner``'s derivations over
    the MERGED per-host sketches: the edges workers actually
    routed by.  Fired ``alert`` events ride along in the same pass
    (one read per metrics file, not one per report section).  Returns
    ``{"per_host": {host: {...}}, "journal_epochs": [...],
    "alerts": [...]}`` — the report's planner/alert sections'
    data."""
    per_host: dict[str, dict] = {}
    alert_events: list[dict] = []
    for path in find_metrics_files(users_dir):
        host = _host_of_metrics_path(path)
        edges, fleet_edges, holds = [], [], 0
        for rec in read_jsonl_tolerant(path):
            ev = rec.get("event")
            if ev == "alert":
                alert_events.append({"host": host, **rec})
            elif ev == "planner_edges":
                edges.append({"t_s": rec.get("t_s"),
                              "edges": rec.get("edges"),
                              "observations": rec.get("observations")})
            elif ev == "fleet_edges":
                # coordinator-broadcast fabric-level edges (the elastic
                # fleet planner) as this host adopted them — rendered
                # alongside the local epochs
                fleet_edges.append({"t_s": rec.get("t_s"),
                                    "edges": rec.get("edges"),
                                    "observations":
                                        rec.get("observations")})
            elif ev == "admission_hold":
                holds += 1
        if edges or fleet_edges or holds:
            per_host[host] = {"edges": edges, "admission_holds": holds}
            if fleet_edges:
                per_host[host]["fleet_edges"] = fleet_edges
    epochs = []
    for rec in read_jsonl_tolerant(os.path.join(users_dir,
                                                "serve_journal.jsonl")):
        if rec.get("event") == "planner":
            epochs.append({"seq": rec.get("seq"),
                           "edges": rec.get("edges"),
                           "observations":
                               (rec.get("sketch") or {}).get("n"),
                           "fleet": bool(rec.get("fleet"))})
    return {"per_host": per_host, "journal_epochs": epochs,
            "alerts": alert_events}


def alert_counts(users_dir: str) -> dict:
    """Fired-alert counts by kind across every host's metrics stream —
    the soak grader's "did the control plane notice" column (and the
    quick health read: a clean steady-state soak fires few; a saturated
    one burns slo_headroom/batch_aging continuously)."""
    counts: dict = {}
    for rec in planner_timeline(users_dir)["alerts"]:
        kind = rec.get("kind")
        if isinstance(kind, str):
            counts[kind] = counts.get(kind, 0) + 1
    return dict(sorted(counts.items()))


def text_report(users_dir: str) -> str:
    """The operator text report: per-phase wall-clock breakdown, dispatch
    occupancy, h2d traffic and admission→finish latency percentiles, per
    host, from the merged metrics + spans."""
    lines = [f"observability report — {users_dir}"]
    merged = merged_summary(users_dir)
    if not merged["per_host"]:
        lines.append("  (no fleet_summary found in any "
                     "fleet_metrics*.jsonl)")
    for host in merged["hosts"]:
        s = merged["per_host"][host]
        lines.append(f"[{host}] users_done={s.get('users_done')} "
                     f"failed={s.get('users_failed')} "
                     f"wall_s={s.get('wall_s')} "
                     f"users/s={s.get('users_per_sec')}")
        phases = s.get("phase_wall_s") or {}
        total = sum(phases.values()) or 1.0
        for k, v in sorted(phases.items(), key=lambda kv: -kv[1]):
            lines.append(f"    {k:<16} {v:>9.3f}s "
                         f"({100.0 * v / total:5.1f}%)")
        lines.append(f"    dispatches={s.get('score_dispatches')} "
                     f"occupancy={s.get('occupancy')} "
                     f"mean_batch={s.get('mean_device_batch')}")
        if s.get("transfer") is not None:
            t = s["transfer"]
            lines.append(f"    h2d_bytes={t.get('h2d_bytes')} "
                         f"({t.get('h2d_bytes_per_select')}/select), "
                         f"h2d_ops={t.get('h2d_ops')}, "
                         f"device_calls/select="
                         f"{t.get('device_calls_per_select')}")
        lat = s.get("admission_to_finish_s")
        if lat is not None:
            lines.append(f"    admission→finish p50={lat.get('p50')}s "
                         f"p95={lat.get('p95')}s p99={lat.get('p99')}s "
                         f"(n={lat.get('n')})")
        per_class = s.get("per_class") or {}
        for cls, c in sorted(per_class.items()):
            clat = c.get("admission_to_finish_s") or {}
            lines.append(f"      [{cls}] users={c.get('users')} "
                         f"p50={clat.get('p50')}s p95={clat.get('p95')}s "
                         f"p99={clat.get('p99')}s")
        planner = s.get("planner")
        if planner is not None:
            lines.append(f"    planner: edges={planner.get('edges')} "
                         f"({planner.get('edge_updates')} update(s) over "
                         f"{planner.get('observations')} obs), holds: "
                         f"admission={planner.get('admission_hold_rounds')}"
                         f" dispatch={planner.get('dispatch_hold_rounds')}")
        per_bucket = s.get("per_bucket") or {}
        for width, b in sorted(per_bucket.items(),
                               key=lambda kv: int(kv[0])):
            lines.append(f"      bucket {width}: occupancy="
                         f"{b.get('occupancy')} mean_batch="
                         f"{b.get('mean_batch')} "
                         f"dispatches={b.get('dispatches')}")
    timeline = planner_timeline(users_dir)
    for host, t in sorted(timeline["per_host"].items()):
        if t["edges"]:
            lines.append(f"planner edges over time [{host}]:")
            for e in t["edges"]:
                lines.append(f"    t={e.get('t_s')}s -> {e.get('edges')} "
                             f"(after {e.get('observations')} obs)")
        if t.get("fleet_edges"):
            lines.append(f"fleet edges adopted [{host}]:")
            for e in t["fleet_edges"]:
                lines.append(f"    t={e.get('t_s')}s -> {e.get('edges')} "
                             f"(after {e.get('observations')} merged "
                             "obs)")
    if timeline["journal_epochs"]:
        # the journal's own planner epochs — in fabric mode the
        # coordinator FleetPlanner's merged-sketch derivations (the
        # edges broadcast to every worker), single-host the local
        # planner's
        lines.append("journal planner epochs:")
        for e in timeline["journal_epochs"]:
            tag = " [fleet-adopt]" if e.get("fleet") else ""
            lines.append(f"    seq={e.get('seq')} -> {e.get('edges')} "
                         f"(sketch n={e.get('observations')}){tag}")
    if timeline["alerts"]:
        lines.append(f"alerts fired: {len(timeline['alerts'])}")
        for r in timeline["alerts"]:
            detail = " ".join(
                f"{k}={v}" for k, v in sorted(r.items())
                if k not in ("schema", "event", "t_s", "kind"))
            lines.append(f"    t={r.get('t_s')}s [{r.get('kind')}] "
                         f"{detail}")
    spans = load_spans(find_span_files(users_dir))
    if spans:
        by_name: dict[str, list[float]] = {}
        hosts = set()
        for r in spans:
            by_name.setdefault(r.get("name") or "span", []).append(
                r.get("dur_s") or 0.0)
            hosts.add(r.get("host") or "local")
        lines.append(f"spans: {len(spans)} across {len(hosts)} host(s)")
        for name, durs in sorted(by_name.items(),
                                 key=lambda kv: -sum(kv[1])):
            lines.append(f"    {name:<16} n={len(durs):<5} "
                         f"total={sum(durs):9.3f}s "
                         f"mean={sum(durs) / len(durs):8.4f}s")
        orphans = orphan_spans(spans)
        if orphans:
            lines.append(f"    WARNING: {len(orphans)} orphan span(s) "
                         "(parent id never written)")
    return "\n".join(lines)
