"""``report``: merge a run's observability artifacts.

Counterpart of ``consensus_entropy_tpu/cli/report.py:1-88`` over the
port's ``obs/export.py``.  It reads the ``users/`` directory a fleet,
serve or fabric run left (``fleet_metrics*.jsonl``, ``spans*.jsonl`` and
each worker's ``fabric/spans_<h>.jsonl``), merges the hosts' streams into
one timeline, and:

- prints the text report (per-phase wall-clock breakdown, dispatch
  occupancy, host-to-device traffic, admission-to-finish percentiles per
  host, overall and per priority class, the SLO planner's edges and
  holds, the span roll-up);
- with ``--out trace.json``, writes the merged Chrome trace-event JSON
  (one process lane per host, one thread lane per user, bucket or run);
- with ``--validate``, checks every metrics line against the schema-v2
  event table and exits 1 on a violation.

Host code only: it runs wherever the artifacts were copied to::

    python -m consensus_entropy_tpu_torch.cli.report models/users
    python -m consensus_entropy_tpu_torch.cli.report models/users --out t.json
    python -m consensus_entropy_tpu_torch.cli.report models/users --validate
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Merge + report a run's observability artifacts "
                    "(spans + metrics) from its users/ directory")
    p.add_argument("users_dir",
                   help="the run's users/ directory (holds "
                        "fleet_metrics*.jsonl, spans*.jsonl and, for "
                        "fabric runs, fabric/spans_<h>.jsonl)")
    p.add_argument("--out", default=None, metavar="TRACE_JSON",
                   help="write the merged Chrome trace-event JSON here "
                        "(Perfetto-loadable; one lane per "
                        "host/user/bucket)")
    p.add_argument("--validate", action="store_true",
                   help="validate every fleet_metrics*.jsonl line "
                        "against the schema-v2 event table; exit 1 on "
                        "any violation")
    p.add_argument("--no-text", action="store_true",
                   help="skip the text report (export/validate only)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from consensus_entropy_tpu_torch.obs import export

    rc = 0
    if args.validate:
        errors = []
        for path in export.find_metrics_files(args.users_dir):
            errors.extend(export.validate_metrics_file(path))
        if errors:
            for e in errors:
                print(f"schema violation: {e}", file=sys.stderr)
            print(f"{len(errors)} schema violation(s)", file=sys.stderr)
            rc = 1
        else:
            n = len(export.find_metrics_files(args.users_dir))
            print(f"schema ok: {n} metrics file(s) valid", file=sys.stderr)
    if args.out:
        spans = export.load_spans(export.find_span_files(args.users_dir))
        trace = export.chrome_trace(spans)
        with open(args.out, "w") as f:
            json.dump(trace, f)
        print(f"wrote {args.out}: {len(trace['traceEvents'])} events "
              f"from {len(spans)} merged spans", file=sys.stderr)
    if not args.no_text:
        print(export.text_report(args.users_dir))
    return rc


if __name__ == "__main__":
    sys.exit(main())
