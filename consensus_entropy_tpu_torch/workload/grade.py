"""The run grader: turn a finished (or killed) serving run's durable
artifacts — the schema-v2 metrics stream and the admission journal —
into a summary.

Counterpart of ``consensus_entropy_tpu/workload/grade.py`` (``:38-166``).
The summary has two sections:

- ``deterministic``: what must replay identically when the same trace is
  played again (the trace digest, arrival counts, each user's final
  disposition from the journal, per-class counts, the zero-loss verdict,
  stream and journal validity);
- ``measured``: host-clock facts that vary run to run (users/s, per-class
  p50/p95/p99 against the SLO targets, driver stats).

Everything reads through the tolerant readers, so grading a killed run
with a torn tail works.  The grader mutates nothing.
"""

from __future__ import annotations

import math

from consensus_entropy_tpu_torch.obs import export
from consensus_entropy_tpu_torch.serve import journal as journal_mod
from consensus_entropy_tpu_torch.workload import trace as trace_mod

#: dispositions a journaled user can end a soak in; anything else (or a
#: user the journal never saw finish) is a LOSS
TERMINAL = ("finish", "poison", "fail")


def percentile(values, q: float) -> float | None:
    """Nearest-rank percentile (q in [0, 100]) without numpy so the
    grader stays importable anywhere; None for no samples."""
    if not values:
        return None
    xs = sorted(float(v) for v in values)
    if len(xs) == 1:
        return xs[0]
    rank = max(0, min(len(xs) - 1,
                      math.ceil(q / 100.0 * len(xs)) - 1))
    return xs[rank]


def _latency_by_class(users_dir: str, classes: dict) -> dict:
    """Per-class end-to-end latencies (enqueue → user_done, seconds)
    from the metrics streams.  Pairs are taken WITHIN one stream file:
    every process stamps ``t_s`` on its own elapsed clock, so a delta
    across files would compare two different time bases.  The finishing
    host's stream always carries both events — a user admitted on one
    host and finished on another (migration, failover) grades from its
    finishing host's re-admission enqueue → user_done."""
    lat_of: dict = {}
    for path in export.find_metrics_files(users_dir):
        t_enq: dict = {}
        t_done: dict = {}
        for rec in export.read_jsonl_tolerant(path):
            ev, user = rec.get("event"), rec.get("user")
            if not isinstance(user, str) \
                    or not isinstance(rec.get("t_s"), (int, float)):
                continue
            if ev == "enqueue":
                t_enq.setdefault(user, rec["t_s"])
            elif ev == "user_done":
                t_done[user] = rec["t_s"]
        for user, done in t_done.items():
            enq = t_enq.get(user)
            if enq is not None and done >= enq:
                lat_of[user] = done - enq
    out: dict = {}
    for user, lat in lat_of.items():
        cls = classes.get(user, "batch")
        out.setdefault(cls, []).append(lat)
    return out


def _stream_errors(users_dir: str) -> list:
    errors = []
    for path in export.find_metrics_files(users_dir):
        errors.extend(export.validate_metrics(
            export.read_jsonl_tolerant(path), path=path))
    return errors


def grade_run(users_dir: str, *, journal_path: str, trace=None,
              slo_s: dict | None = None, wall_s: float | None = None,
              driver_stats: dict | None = None) -> dict:
    """Grade one soak run directory.  ``journal_path`` is the admission
    journal (fabric: the coordinator's main journal) — the ledger the
    zero-loss check and dispositions come from; ``trace`` (a
    :class:`~workload.trace.Trace`) pins which users MUST be accounted
    for and stamps the digest; ``slo_s`` (``{class: target_s}``) grades
    the percentiles; ``wall_s`` (driver-measured span) yields sustained
    users/sec; ``driver_stats`` folds the producer's backpressure view
    in."""
    st = journal_mod._replay(journal_path)
    journal_errors = journal_mod.validate_journal_file(journal_path)
    stream_errors = _stream_errors(users_dir)

    expected = list(trace.users) if trace is not None \
        else sorted(st.last)
    dispositions = {u: st.last.get(u) for u in expected}
    lost = sorted(u for u, d in dispositions.items()
                  if d not in TERMINAL)
    finished = sorted(u for u, d in dispositions.items()
                      if d == "finish")
    classes = dict(st.classes)
    if trace is not None:
        for ev in trace.events:
            if ev["kind"] == "arrive":
                classes.setdefault(ev["user"], ev["cls"])
    class_counts: dict = {}
    for u in expected:
        cls = classes.get(u, "batch")
        class_counts[cls] = class_counts.get(cls, 0) + 1

    deterministic = {
        "trace_sha": trace_mod.trace_digest(trace)
        if trace is not None else None,
        "n_arrivals": len(expected),
        "finished": len(finished),
        "dispositions": dict(sorted(dispositions.items())),
        "class_counts": dict(sorted(class_counts.items())),
        "lost_users": lost,
        "zero_loss": not lost,
        "journal_ok": not journal_errors,
        "stream_ok": not stream_errors,
    }

    lat = _latency_by_class(users_dir, classes)
    per_class = {}
    for cls in sorted(set(lat) | set(slo_s or {})):
        xs = lat.get(cls, [])
        target = (slo_s or {}).get(cls)
        row = {"n": len(xs),
               "p50_s": percentile(xs, 50),
               "p95_s": percentile(xs, 95),
               "p99_s": percentile(xs, 99),
               "slo_s": target}
        if target is not None and row["p95_s"] is not None:
            row["within_slo"] = bool(row["p95_s"] <= target)
        per_class[cls] = row

    measured = {
        "wall_s": wall_s,
        "users_per_sec": (len(finished) / wall_s
                          if wall_s and wall_s > 0 else None),
        "per_class": per_class,
        "alerts": export.alert_counts(users_dir),
        "driver": dict(driver_stats or {}),
        "journal_errors": journal_errors[:5],
        "stream_errors": stream_errors[:5],
    }
    return {"deterministic": deterministic, "measured": measured}


def deterministic_equal(a: dict, b: dict) -> bool:
    """The determinism pin: two plays of the same trace file must agree
    on the entire ``deterministic`` section (dispositions included)."""
    return a.get("deterministic") == b.get("deterministic")
