"""Evidence CLI: does consensus-entropy acquisition beat random?

Counterpart of ``consensus_entropy_tpu/cli/evidence.py:20-231``, with the
same subcommands and flags and ``--device {cuda,cpu}`` (default ``cuda``).

``sweep``   runs the synthetic matched-budget experiment (N seeds x modes
            through the production ALLoop) and writes an evidence JSON with
            mean trajectories and the paper's pairwise one-sided t-tests
            (section 4.1; ``rand`` is the control, ``amg_test.py:486-489``).
``analyze`` runs the same paired analysis over a run's
            ``models/users/{uid}/{mode}/metrics.jsonl`` files.

    python -m consensus_entropy_tpu_torch.cli.evidence sweep --seeds 4 \
        --out EVIDENCE.json [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile


def build_parser() -> argparse.ArgumentParser:
    from consensus_entropy_tpu_torch.cli.common import add_device_arg

    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    sw = sub.add_parser("sweep", help="synthetic matched-budget mode sweep")
    sw.add_argument("--seeds", type=int, default=20,
                    help="number of synthetic users (paired across modes)")
    sw.add_argument("--queries", type=int, default=5)
    sw.add_argument("--epochs", type=int, default=8)
    sw.add_argument("--songs", type=int, default=250)
    sw.add_argument("--cnn-members", type=int, default=0,
                    help="add N tiny CNN fold-members (synthetic tone "
                         "waveforms) so the sweep exercises the CNN "
                         "scoring/retraining species through the "
                         "production loop; pair with enough "
                         "--cnn-pretrain-epochs that the members are "
                         "stable under entropy-concentrated batches (see "
                         "al/evidence.py make_committee)")
    sw.add_argument("--cnn-pretrain-epochs", type=int, default=10,
                    help="pretraining depth for the CNN fold-members; "
                         "10-epoch members are weak enough to DEGRADE "
                         "under uncertainty-targeted batches, deeper "
                         "pretraining makes them benefit")
    sw.add_argument("--cnn-retrain-epochs", type=int, default=5,
                    help="CNN retrain epochs per AL iteration in the "
                         "cnn-members sweep")
    sw.add_argument("--easy-delta", type=float, default=None,
                    help="place class 1's center this far from class 0's "
                         "(mild learnable ambiguity in the abundant pair "
                         "so query batches span classes; default: off — "
                         "see al/evidence.py make_user)")
    sw.add_argument("--hard-delta", type=float, default=0.9,
                    help="distance between the rare confusable pair's "
                         "centers (make_user hard_delta)")
    sw.add_argument("--cnn-pretrain-songs", type=int, default=None,
                    metavar="N",
                    help="pretrain each CNN fold-member on a deeper pool "
                         "sample: N songs for each ABUNDANT class and "
                         "~N/3 for each rare class (the GNB folds' 3:1 "
                         "PRETRAIN_SONGS asymmetry; default: the folds' "
                         "8-song slices).  The reference's CNN folds see "
                         "whole DEAM CV folds, so a deeper sample is the "
                         "closer analogue")
    sw.add_argument("--sgd-members", type=int, default=0,
                    help="add N SGD fold-members (full-committee sweeps; "
                         "SGD's partial_fit instability under concentrated "
                         "batches is a member property — see "
                         "al/evidence.py make_committee)")
    sw.add_argument("--cnn-registry", default=None, metavar="DIR",
                    help="load CNN fold-members from this pretrained "
                         "registry (classifier_cnn.it_{i}.npz) instead "
                         "of pretraining tiny members per seed — the "
                         "reference's copy-the-DEAM-committee-per-user "
                         "structure.  Pair with --full-geometry when the "
                         "registry holds reference-geometry members")
    sw.add_argument("--full-geometry", action="store_true",
                    help="pool waveforms + CNN config at the reference "
                         "geometry (59049 samples, 128 mels, 7 blocks) "
                         "and production retrain config; requires "
                         "--cnn-registry (pretraining full-geometry "
                         "members per seed is a wall-clock non-starter)")
    sw.add_argument("--unfamiliar-mapping", action="store_true",
                    help="shift the unfamiliar songs' class→frequency "
                         "mapping (USER_FREQS) on top of the timbre "
                         "change — the full-geometry mechanism-study "
                         "axis (mapping novelty creates CNN headroom; "
                         "timbre novelty alone is transparent to a "
                         "full-geometry mel CNN)")
    sw.add_argument("--gate-host-updates", action="store_true",
                    help="validation-gate host-member incremental updates "
                         "(ALConfig.gate_host_updates) — the host analogue "
                         "of the reference's CNN best-checkpoint gate; an "
                         "opt-in extension the reference lacks")
    sw.add_argument("--modes", default="mc,hc,mix,rand")
    sw.add_argument("--baseline", default="rand",
                    help="control mode for the paired tests; tests are "
                         "skipped (with a note) if it isn't in --modes")
    sw.add_argument("--out", default="EVIDENCE.json")
    sw.add_argument("--workdir", default=None,
                    help="keep per-run workspaces here (default: temp dir)")

    an = sub.add_parser("analyze", help="paired t-tests over real runs")
    an.add_argument("users_root", help="the AL CLI's models/users directory")
    an.add_argument("--modes", default="mc,hc,mix,rand")
    an.add_argument("--baseline", default="rand")
    an.add_argument("--out", default=None,
                    help="also write the analysis JSON here")
    for s in (sw, an):
        add_device_arg(s)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from consensus_entropy_tpu_torch.al import evidence
    from consensus_entropy_tpu_torch.device import resolve_device

    device = resolve_device(args.device)

    modes = tuple(args.modes.split(","))
    if args.cmd == "analyze":
        report = evidence.analyze_users(args.users_root, modes=modes,
                                        baseline=args.baseline)
        print(json.dumps(report, indent=2))
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(report, fh, indent=2)
        return 0

    seeds = list(range(args.seeds))
    print(f"sweep: {len(seeds)} seeds x {modes}, q={args.queries} x "
          f"e={args.epochs} on {args.songs}-song pools")
    cleanup = None
    if args.workdir:
        workdir = args.workdir
    else:  # per-run AL workspaces are scratch unless the user keeps them
        cleanup = tempfile.TemporaryDirectory(prefix="ce_evidence_")
        workdir = cleanup.name
    cnn_cfg, cnn_retrain = evidence.CNN_CFG, evidence.CNN_RETRAIN
    if args.full_geometry:
        if not args.cnn_registry:
            print("--full-geometry requires --cnn-registry")
            return 2
        from consensus_entropy_tpu_torch.config import CNNConfig, TrainConfig

        cnn_cfg, cnn_retrain = CNNConfig(), TrainConfig()
    try:
        results = evidence.sweep(
            seeds, workdir, modes=modes, queries=args.queries,
            epochs=args.epochs, n_songs=args.songs,
            cnn_members=args.cnn_members,
            cnn_pretrain_epochs=args.cnn_pretrain_epochs,
            cnn_retrain_epochs=args.cnn_retrain_epochs,
            cnn_pretrain_songs=args.cnn_pretrain_songs,
            easy_delta=args.easy_delta, hard_delta=args.hard_delta,
            sgd_members=args.sgd_members, cnn_registry=args.cnn_registry,
            cnn_cfg=cnn_cfg, cnn_retrain=cnn_retrain,
            unfamiliar_freqs=(evidence.USER_FREQS
                              if args.unfamiliar_mapping else None),
            gate_host_updates=args.gate_host_updates, device=device)
    finally:
        if cleanup is not None:
            cleanup.cleanup()
    if args.baseline in results:
        tests = evidence.paired_tests(results, baseline=args.baseline)
    else:
        tests = {"skipped": f"baseline {args.baseline!r} not in --modes"}
        print(tests["skipped"])
    report = {
        "experiment": {"seeds": len(seeds), "modes": list(modes),
                       "queries": args.queries, "epochs": args.epochs,
                       "songs": args.songs,
                       "easy_delta": args.easy_delta,
                       "hard_delta": args.hard_delta,
                       "unfamiliar_mapping": args.unfamiliar_mapping,
                       "gate_host_updates": args.gate_host_updates,
                       "committee": (
                           "5x gnb fold-members"
                           + (f" + {args.sgd_members}x sgd fold-members"
                              if args.sgd_members else "")
                           + (f" + {args.cnn_members or 5}x "
                              f"{'full-geometry ' if args.full_geometry else ''}"
                              f"cnn from registry {args.cnn_registry} "
                              "(DEAM-scale pretraining, copied per seed; "
                              f"retrain {args.cnn_retrain_epochs} ep)"
                              if args.cnn_registry else
                              (f" + {args.cnn_members}x tiny cnn "
                               f"(pretrain {args.cnn_pretrain_epochs} ep"
                               + (f" on {args.cnn_pretrain_songs}"
                                  "/abundant-class (3:1 rare)"
                                  if args.cnn_pretrain_songs else "")
                               + f", retrain {args.cnn_retrain_epochs} ep)"
                               if args.cnn_members else ""))),
                       "reference_row": "paper §4.1 (MC>RAND p=0.0291, "
                                        "d.f.=229)"},
        "trajectories": evidence.trajectories(results),
        "tests": tests,
        # raw per-(mode, seed, epoch, member) F1s: the artifact must let a
        # reader re-slice (species, AUC, any pairing) without re-running
        "raw": {m: {str(s): v for s, v in by_seed.items()}
                for m, by_seed in results.items()},
    }
    if args.cnn_registry and args.baseline in results:
        n_cnn = args.cnn_members or 5
        slices = {"cnn": slice(0, n_cnn),
                  "gnb": slice(n_cnn, n_cnn + 5)}
        if args.sgd_members:
            slices["sgd"] = slice(n_cnn + 5, n_cnn + 5 + args.sgd_members)
        report["species_tests"] = evidence.species_tests(
            results, slices, baseline=args.baseline)
        for name, t in report["species_tests"].items():
            print(f"  {name}: t={t['t']:.3f} p={t['p']:.4f} "
                  f"(Δ={t['mean_diff']:+.4f})")
    for name, t in tests.items():
        if not isinstance(t, dict):
            continue
        pm = t["per_member_final"]
        print(f"{name}: per-member final t={pm['t']:.3f} p={pm['p']:.4f} "
              f"(d.f.={pm['df']}, Δ={pm['mean_diff']:+.4f}); "
              f"per-seed AUC p={t['per_seed_auc']['p']:.4f}")
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=2)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
