"""``soak``: generate, inspect and grade soak workload traces.

Counterpart of ``consensus_entropy_tpu/cli/soak.py:1-195`` over the
port's ``workload/``; host code only:

- ``gen`` writes a seeded ``trace.jsonl`` from load-shape flags (arrival
  process, class mix, pool distribution, churn) and prints its digest; the
  same flags write the same bytes as the JAX package's ``gen``;
- ``digest`` validates a trace file and prints its digest and shape;
- ``grade`` grades a finished, killed or running run directory (the
  journal decides zero loss and dispositions, the metrics streams give
  per-class latencies and alert counts) and prints one JSON object; it
  exits 1 on a lost user or schema damage unless ``--no-gate``.

Examples::

    python -m consensus_entropy_tpu_torch.cli.soak gen /tmp/trace.jsonl \
        --users 32 --arrival mmpp --churn-frac 0.25 --horizon-s 300
    python -m consensus_entropy_tpu_torch.cli.soak digest /tmp/trace.jsonl
    python -m consensus_entropy_tpu_torch.cli.soak grade DIR \
        --journal DIR/serve_journal.jsonl --trace /tmp/trace.jsonl \
        --slo interactive=5,batch=30
"""

from __future__ import annotations

import argparse
import json
import sys


def _parse_pairs(text: str, what: str) -> list:
    """``a=1,b=2`` → ``[("a", 1.0), ("b", 2.0)]`` (shared by the class
    mix and the SLO map)."""
    out = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition("=")
        if not name or not val:
            raise SystemExit(f"cetpu-soak: bad {what} entry {part!r} "
                             f"(want name=value,...)")
        try:
            out.append((name.strip(), float(val)))
        except ValueError:
            raise SystemExit(f"cetpu-soak: {what} value in {part!r} "
                             "is not a number")
    if not out:
        raise SystemExit(f"cetpu-soak: empty {what}")
    return out


def _cmd_gen(args) -> int:
    from consensus_entropy_tpu_torch.workload import (
        TraceSpec, generate, save, trace_digest)

    try:
        spec = TraceSpec(
            seed=args.seed, n_users=args.users, arrival=args.arrival,
            rate=args.rate, burst_rate=args.burst_rate,
            burst_dwell_s=args.burst_dwell_s,
            timestamps=tuple(args.timestamps or ()),
            class_mix=tuple(_parse_pairs(args.class_mix, "class mix")),
            pool_dist=args.pool_dist,
            pool_sizes=tuple(args.pool_sizes),
            churn_frac=args.churn_frac,
            churn_delay_s=args.churn_delay_s,
            reconnect_s=args.reconnect_s,
            horizon_s=args.horizon_s)
    except ValueError as e:
        raise SystemExit(f"cetpu-soak: {e}")
    trace = generate(spec)
    save(trace, args.out)
    print(json.dumps({
        "trace": args.out,
        "trace_sha": trace_digest(trace),
        "n_users": spec.n_users,
        "events": len(trace.events),
        "horizon_s": trace.horizon_s,
    }))
    return 0


def _cmd_digest(args) -> int:
    from consensus_entropy_tpu_torch.workload import load, trace_digest

    try:
        trace = load(args.trace)
    except (OSError, ValueError) as e:
        raise SystemExit(f"cetpu-soak: {e}")
    kinds: dict = {}
    for ev in trace.events:
        kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
    print(json.dumps({
        "trace": args.trace,
        "trace_sha": trace_digest(trace),
        "n_users": len(trace.users),
        "events": dict(sorted(kinds.items())),
        "horizon_s": trace.horizon_s,
    }))
    return 0


def _cmd_grade(args) -> int:
    from consensus_entropy_tpu_torch.workload import grade_run, load

    trace = None
    if args.trace:
        try:
            trace = load(args.trace)
        except (OSError, ValueError) as e:
            raise SystemExit(f"cetpu-soak: {e}")
    slo = dict(_parse_pairs(args.slo, "slo")) if args.slo else None
    summary = grade_run(args.users_dir, journal_path=args.journal,
                        trace=trace, slo_s=slo, wall_s=args.wall_s)
    print(json.dumps(summary, sort_keys=True))
    det = summary["deterministic"]
    ok = det["zero_loss"] and det["journal_ok"] and det["stream_ok"]
    # a non-zero exit on loss or schema damage makes `grade` a gate
    return 0 if ok or args.no_gate else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Soak workload traces: generate, inspect, grade")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen", help="generate a seeded trace.jsonl")
    g.add_argument("out", help="trace file to write")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--users", type=int, default=8)
    g.add_argument("--arrival", choices=("poisson", "mmpp", "replay"),
                   default="poisson")
    g.add_argument("--rate", type=float, default=4.0,
                   help="arrivals/sec (poisson; the calm mmpp state)")
    g.add_argument("--burst-rate", type=float, default=0.0,
                   help="mmpp burst-state arrivals/sec (0 = 8x rate)")
    g.add_argument("--burst-dwell-s", type=float, default=1.0,
                   help="mean seconds per mmpp state")
    g.add_argument("--timestamps", type=float, nargs="*", default=None,
                   help="explicit offsets for --arrival replay")
    g.add_argument("--class-mix", default="interactive=0.5,batch=0.5",
                   metavar="CLS=W,...",
                   help="priority-class weights "
                        "(default interactive=0.5,batch=0.5)")
    g.add_argument("--pool-dist", choices=("bucket", "skew", "cycle"),
                   default="bucket")
    g.add_argument("--pool-sizes", type=int, nargs="+",
                   default=[12, 30, 60, 120])
    g.add_argument("--churn-frac", type=float, default=0.0,
                   help="fraction of users that disconnect + reconnect")
    g.add_argument("--churn-delay-s", type=float, default=1.0)
    g.add_argument("--reconnect-s", type=float, default=2.0)
    g.add_argument("--horizon-s", type=float, default=None,
                   help="stretch arrivals so the last lands here "
                        "(the soak's wall span)")
    g.set_defaults(fn=_cmd_gen)

    d = sub.add_parser("digest",
                       help="validate a trace file, print its digest")
    d.add_argument("trace", help="trace.jsonl to inspect")
    d.set_defaults(fn=_cmd_digest)

    r = sub.add_parser("grade", help="grade a soak run directory")
    r.add_argument("users_dir",
                   help="the run directory holding the "
                        "fleet_metrics*.jsonl streams (fabric dir)")
    r.add_argument("--journal", required=True,
                   help="the admission journal (the zero-loss ledger)")
    r.add_argument("--trace", default=None,
                   help="the trace file the run played (pins which "
                        "users must be accounted for + the digest)")
    r.add_argument("--slo", default=None, metavar="CLS=S,...",
                   help="per-class SLO targets in seconds, e.g. "
                        "interactive=5,batch=30")
    r.add_argument("--wall-s", type=float, default=None,
                   help="driver-measured wall span (yields users/sec)")
    r.add_argument("--no-gate", action="store_true",
                   help="always exit 0 (default: non-zero on user "
                        "loss or schema damage — the CI gate)")
    r.set_defaults(fn=_cmd_grade)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
