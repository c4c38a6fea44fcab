"""AL personalization CLI, sequential: ``amg_test.py -q 10 -e 10 -m mc
-n 150`` (``amg_test.py:542-585``) plus ``--device {cuda,cpu}``.

    python -m consensus_entropy_tpu_torch.cli.amg_test -q 10 -e 10 -m mc \\
        -n 150 --models-root models --amg-root data/amg1608

Per user: copy the pretrained committee into a private workspace, run the
consensus-entropy AL loop, persist the members and reports, mark the user
done (a rerun skips done users and resumes a partial one).  The registry
holds the port's member files (``convert.registry_from_jax`` makes them
from a JAX registry); when it holds CNN members, the waveforms come from
``{amg_root}/npy/{song_id}.npy`` into a store on the device, and qbdc
runs; ``--cnn-arch`` names the members' trunk family (any of the five)
and ``--full-song-hop`` scores whole songs on a window grid.  ``--fleet
N`` runs the users in cohorts of N through ``fleet.FleetScheduler``
(``amg_test.py:833-940`` of the JAX CLI): each user's workspace and
result are the sequential run's.  ``--mesh auto|N|DEVICES`` splits
every pool (and a CNN forward's crop rows, and the retrain's members)
across N devices: the first N cards, N entries of the CPU with
``--device cpu``, or a device list (``cuda:0,cuda:0`` holds a 2-way mesh
on one card); ``--fleet`` composes with it.  ``--distributed COORD,N,ID`` joins
N processes over ``torch.distributed`` first (with ``--mesh auto``): each
holds its share of every pool, the coordinator writes the workspaces.

``--serve N`` (``amg_test.py:941-1090`` of the JAX CLI) serves the users
through ``serve.FleetServer``: N sessions live, a freed slot refilled at
once from the waiting queue, each user padded to its bucket
(``--bucket-widths``, or edges the SLO planner derives), every admission
transition in the journal ``users/serve_journal.jsonl`` (a killed run
restarted with the same flags loses no user), finished users persisted
the moment they finish.  ``--watchdog-s``, ``--failure-budget`` and the
breaker flags set its fault domain; ``--unpoison U`` removes users from
the poison list and exits.  Fleet and serve runs write spans to
``spans.jsonl`` in the users directory, or in ``--trace-dir``
(``--no-trace`` turns them off); ``--torch-profile DIR`` (the JAX CLI's
``--jax-profile``) captures the first ``--torch-profile-n`` device
dispatches with ``torch.profiler``.  On the sequential path
``--trace-dir DIR`` takes a ``torch.profiler`` trace of each user's run,
as the JAX CLI's takes a ``jax.profiler`` one.

``--serve N --hosts H`` (``amg_test.py:1124-1352`` of the JAX CLI) runs
the multi-host fabric: this process becomes the coordinator (it owns
``users/serve_journal.jsonl`` and never touches the device) and starts H
worker processes, each ``python -m consensus_entropy_tpu_torch.cli.
amg_test ... --fabric-worker h<i> --fabric-dir users/fabric`` with the
same flags (``--device`` passed through) serving N sessions; a worker
that dies or stops heartbeating (``--lease-s``) is killed and its users
move to the others, resuming from their workspaces.  ``--min-hosts`` /
``--max-hosts`` turn the autoscaler on, ``--scale-down-s`` graceful
scale-down, ``--drain-host`` an operator drain, ``--fence-deadline-s``
the fence deadline and ``--remedy`` (with ``--remedy-hold-s``,
``--remedy-cooldown-s``, ``--remedy-skew``) the skew remediation;
``--mesh-devices K`` serves each worker on a K-way pool mesh (K entries
of ``cuda:0``, or of the CPU with ``--device cpu``) and ``--placement``
picks the cross-host routing.  Serve and fabric runs keep the operator
plane on (``amg_test.py:804-819`` of the JAX CLI): each process, the
coordinator and every worker writes ``users/status/status_<host>.json``
(``obs.status``; ``cli.top`` renders them) and evaluates the SLO and
fleet alerts, which ``--alert-sink`` routes to sinks;
``--no-introspection`` turns the plane off.  Per-user results are the
same bits either way.
"""

from __future__ import annotations

import argparse
import os
import sys

from consensus_entropy_tpu_torch.cli.common import (
    add_device_arg,
    add_path_args,
    resolve_cnn_config,
)
from consensus_entropy_tpu_torch.config import CNN_ARCHS


def build_parser() -> argparse.ArgumentParser:
    from consensus_entropy_tpu_torch import acquire

    p = argparse.ArgumentParser(
        description="Consensus-entropy active learning on AMG1608")
    p.add_argument("-q", "--queries", required=True, type=int,
                   help="queries per AL iteration")
    p.add_argument("-e", "--epochs", required=True, type=int,
                   help="AL iterations")
    p.add_argument("-n", "--num_anno", required=True, type=int,
                   help="minimum annotations per user")
    p.add_argument("-m", "--mode", "--al-mode", required=True,
                   choices=acquire.available_modes(),
                   help="acquisition: machine consensus [mc], human "
                        "consensus [hc], both [mix], random [rand], "
                        "query-by-dropout-committee [qbdc], weighted "
                        "machine consensus [wmc]")
    p.add_argument("--qbdc-k", type=int, default=20, metavar="K",
                   help="qbdc: dropout-committee width")
    p.add_argument("--consensus-weighting",
                   choices=("agreement", "uniform"), default="agreement",
                   help="wmc: 'agreement' moves each member's weight by an "
                        "EMA toward its post-reveal agreement; 'uniform' "
                        "keeps every weight at 1 (wmc is then mc)")
    p.add_argument("--max-users", type=int, default=None,
                   help="cap the user count (debug)")
    p.add_argument("--fleet", type=int, default=None, metavar="N",
                   help="run users through the fleet engine, N concurrent "
                        "AL sessions per cohort: their scoring and CNN "
                        "device calls stack into one dispatch and host "
                        "retraining overlaps device work; per-user "
                        "results are the sequential run's")
    p.add_argument("--fleet-host-workers", type=int, default=None,
                   help="bounded worker pool for the fleet's host-side "
                        "retraining/evaluation (default: min(N, cpus, 8))")
    p.add_argument("--plan-chunk", type=int, default=None, metavar="U",
                   help="fleet mode: serve stacked CNN plan groups in "
                        "dispatches of at most U users, holding a partial "
                        "chunk back while host steps are in flight "
                        "(default: whole groups)")
    p.add_argument("--no-stack-cnn", action="store_true",
                   help="fleet mode: run the CNN device work (probs "
                        "forward, qbdc, retraining) inline per user "
                        "instead of stacked across the cohort (same "
                        "per-user results)")
    p.add_argument("--no-fuse-step", action="store_true",
                   help="score, pull the result and update the masks on "
                        "the host each iteration instead of the fused "
                        "select (same selections)")
    p.add_argument("--serve", type=int, default=None, metavar="N",
                   help="serving mode: keep N AL sessions live, admitting "
                        "a queued user the moment a session finishes, each "
                        "user padded to its bucket instead of the cohort "
                        "max; SIGTERM drains (in-flight users finish, "
                        "queued users wait for the rerun, exit 75); "
                        "per-user results are the sequential run's")
    p.add_argument("--admit-window-ms", type=float, default=0.0,
                   help="serve mode: with free slots and an empty queue, "
                        "wait up to this long for more arrivals so they "
                        "are admitted together (default 0)")
    p.add_argument("--bucket-widths", default=None, metavar="W1,W2,...",
                   help="serve mode: explicit pool-width bucket edges "
                        "(comma-separated ascending ints); larger pools "
                        "fall through to the next power of two (default: "
                        "power-of-two buckets, or the SLO planner's)")
    p.add_argument("--no-slo-planner", action="store_true",
                   help="serve mode: disable the SLO admission planner "
                        "(journaled adaptive bucket edges, adaptive holds "
                        "inside per-class SLO headroom); per-user results "
                        "are the same either way")
    p.add_argument("--slo-interactive-s", type=float, default=60.0,
                   metavar="S",
                   help="serve mode: admission->finish latency target of "
                        "the 'interactive' class (default 60)")
    p.add_argument("--slo-batch-s", type=float, default=600.0, metavar="S",
                   help="serve mode: admission->finish latency target of "
                        "the 'batch' class (default 600)")
    p.add_argument("--priority-aging-s", type=float, default=30.0,
                   metavar="S",
                   help="serve mode: queue wait past which a 'batch' user "
                        "pops ahead of fresh 'interactive' arrivals (0 = "
                        "strict priority; default 30)")
    p.add_argument("--interactive-users", default=None,
                   metavar="USER[,USER...]",
                   help="serve mode: submit these user ids in the "
                        "'interactive' class; everyone else is 'batch'")
    p.add_argument("--no-serve-journal", action="store_true",
                   help="serve mode: no admission journal "
                        "(users/serve_journal.jsonl; with it, a killed run "
                        "restarted with the same flags skips finished "
                        "users, re-admits in-flight ones and re-queues "
                        "waiting ones)")
    p.add_argument("--watchdog-s", type=float, default=0.0, metavar="S",
                   help="serve mode: wall-clock deadline per engine step "
                        "(host block or device dispatch); a hung step's "
                        "session is evicted and resumed (default 0: off)")
    p.add_argument("--failure-budget", type=int, default=3, metavar="N",
                   help="serve mode: admissions per user; a terminally "
                        "failed session is re-queued with seeded backoff "
                        "until the budget is spent, then poisoned "
                        "(users/serve_poison.jsonl) and skipped (default 3)")
    p.add_argument("--breaker-threshold", type=int, default=2, metavar="N",
                   help="serve mode: consecutive stacked-dispatch failures "
                        "that degrade a bucket to per-user dispatch until a "
                        "half-open probe succeeds (0 disables; default 2)")
    p.add_argument("--breaker-cooldown-s", type=float, default=30.0,
                   metavar="S",
                   help="serve mode: how long an open bucket stays "
                        "degraded before its probe (default 30)")
    p.add_argument("--breaker-probes", type=int, default=0, metavar="N",
                   help="serve mode: failed probes before a bucket stays "
                        "per-user for the run (0 = probe forever)")
    p.add_argument("--journal-compact-kb", type=int, default=0,
                   metavar="KB",
                   help="serve mode: compact the admission journal "
                        "whenever it grows past this size (0 = never)")
    p.add_argument("--hosts", type=int, default=None, metavar="N",
                   help="multi-host fabric: shard admitted users across N "
                        "worker processes (each running its own --serve "
                        "engine), coordinated through the admission "
                        "journal; a worker that dies or stops heartbeating "
                        "(--lease-s) is killed and its users fail over to "
                        "the others, in-flight users resuming from their "
                        "workspaces (requires --serve)")
    p.add_argument("--lease-s", type=float, default=5.0, metavar="S",
                   help="fabric: worker heartbeat lease; a host whose last "
                        "heartbeat is older is declared dead (default 5)")
    p.add_argument("--min-hosts", type=int, default=None, metavar="N",
                   help="elastic fabric: turn the autoscaler on and keep "
                        "at least N live workers (a dead worker is "
                        "replaced under a fresh host id; queued users "
                        "rebalance onto joiners)")
    p.add_argument("--max-hosts", type=int, default=None, metavar="N",
                   help="elastic fabric: scale-up ceiling for the backlog "
                        "and SLO-headroom signals (default: --hosts when "
                        "--min-hosts is given)")
    p.add_argument("--scale-down-s", type=float, default=0.0, metavar="S",
                   help="elastic fabric: once the scale-up signals stay "
                        "quiet at one host fewer for S seconds above "
                        "--min-hosts, drain one surplus host (queued "
                        "users rebalance, in-flight users migrate through "
                        "a checkpoint fence); requires --min-hosts/"
                        "--max-hosts (default 0: never)")
    p.add_argument("--mesh-devices", default=None, metavar="N|N0,N1,...",
                   help="fabric: devices per worker; one int applies "
                        "fleet-wide, a comma list gives per-host widths "
                        "(length must equal --hosts).  Each worker serves "
                        "on a pool mesh of that width and advertises it "
                        "in its heartbeat (requires --hosts)")
    p.add_argument("--placement", choices=("bucket", "load"),
                   default="bucket",
                   help="fabric: cross-host routing; 'bucket' co-locates "
                        "users of one pool-width bucket (within a load "
                        "skew bound), 'load' is least-loaded")
    p.add_argument("--drain-host", default=None, metavar="H",
                   help="elastic fabric operator command: drain host H "
                        "through the scale-down machinery once it is live "
                        "(requires --min-hosts/--max-hosts)")
    p.add_argument("--fence-deadline-s", type=float, default=0.0,
                   metavar="S",
                   help="elastic fabric: a checkpoint-fence migration not "
                        "acked within S seconds falls back to "
                        "evict+resume at the next step boundary (default "
                        "0: wait for the checkpoint; requires --min-hosts/"
                        "--max-hosts)")
    p.add_argument("--remedy", action="store_true",
                   help="elastic fabric: a placement-skew alert held for "
                        "--remedy-hold-s sheds the overloaded host's "
                        "surplus users (queued by drop-ack, in flight by "
                        "checkpoint fence), journaled (requires "
                        "--min-hosts/--max-hosts)")
    p.add_argument("--remedy-hold-s", type=float, default=1.0, metavar="S",
                   help="remedy: how long a skew alert must hold before "
                        "the pump acts (default 1)")
    p.add_argument("--remedy-cooldown-s", type=float, default=5.0,
                   metavar="S",
                   help="remedy: minimum spacing between remediations, "
                        "fleet-wide (default 5)")
    p.add_argument("--remedy-skew", type=int, default=None, metavar="N",
                   help="remedy: load above the fleet minimum that counts "
                        "as skew, the alert threshold and the shed target "
                        "(default: the placement skew bound)")
    p.add_argument("--alert-sink", action="append", default=None,
                   metavar="SPEC",
                   help="route alert transitions to a sink (repeatable): "
                        "'console' (stderr lines), 'jsonl:<path>' "
                        "(append one record per transition), or "
                        "'cmd:<argv>' (run a command per transition, "
                        "the record as JSON on argv[-1] — webhook-"
                        "shaped); sink failures count in the status "
                        "snapshot but never affect serving (requires "
                        "the introspection plane)")
    p.add_argument("--no-introspection", action="store_true",
                   help="serve/fabric: disable the live introspection "
                        "plane — the coordinator's control-plane trace "
                        "lane, status_<host>.json snapshots (the top "
                        "feed) and SLO burn-rate alerts (ON by default; "
                        "observation only, per-user results are "
                        "bit-identical either way; the port emits no "
                        "compile events, so there are none to switch)")
    p.add_argument("--fabric-worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--fabric-dir", default=None, help=argparse.SUPPRESS)
    p.add_argument("--unpoison", default=None, metavar="USER[,USER...]",
                   help="operator command: remove users from the poison "
                        "list (journaled records), then exit")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="fleet/serve: write the span file here (default: "
                        "the users directory); sequential: a torch.profiler "
                        "trace of each user's run")
    p.add_argument("--no-trace", action="store_true",
                   help="fleet/serve: no span tracer (spans.jsonl: "
                        "run -> user -> al_iter -> dispatch spans with "
                        "deterministic ids)")
    p.add_argument("--torch-profile", default=None, metavar="DIR",
                   help="fleet/serve: capture the first --torch-profile-n "
                        "device dispatches with torch.profiler (CUDA "
                        "activity) into DIR as a Chrome trace")
    p.add_argument("--torch-profile-n", type=int, default=10, metavar="N",
                   help="device dispatches to keep the profiler open for "
                        "(default 10)")
    p.add_argument("--seed", type=int, default=1987)
    p.add_argument("--tie-break", choices=("fast", "numpy"), default="fast")
    p.add_argument("--pad-pool-to", type=int, default=None, metavar="N",
                   help="pad every user's pool to one width")
    p.add_argument("--device-members", action="store_true",
                   help="score the GaussianNB/SGD members on the device, "
                        "fused with the frame->song mean")
    p.add_argument("--retrain-epochs", type=int, default=None,
                   help="CNN retrain epochs per AL iteration (default "
                        "TrainConfig.n_epochs_retrain)")
    p.add_argument("--cnn-config-json", default=None, metavar="JSON",
                   help="CNNConfig field overrides as a JSON object (must "
                        "match the pre-trained geometry)")
    p.add_argument("--full-song-hop", type=int, default=None, metavar="HOP",
                   help="CNN members score each song as the deterministic "
                        "mean over stride-HOP windows covering the whole "
                        "waveform, instead of one random crop per pass")
    p.add_argument("--cnn-arch", default=None, choices=CNN_ARCHS,
                   help="trunk family of the pre-trained CNN committee")
    p.add_argument("--mesh", default=None, metavar="auto|N",
                   help="shard the scoring path (CNN forward + fused "
                        "mean->entropy->top-k) over a pool-axis device mesh: "
                        "'auto' = all visible devices, N = first N devices "
                        "(N entries of the CPU with --device cpu), or a "
                        "device list such as cuda:0,cuda:0 (a device may "
                        "repeat: its shards run one after another there)")
    p.add_argument("--distributed", default=None, metavar="COORD,N,ID",
                   help="join a multi-process run before touching the "
                        "device: coordinator host:port, process count, this "
                        "process's id (parallel.multihost over "
                        "torch.distributed; requires --mesh auto)")
    add_path_args(p)
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # the fabric coordinator re-execs its workers with these flags
    args._raw_argv = list(sys.argv[1:] if argv is None else argv)
    if args.unpoison is not None:
        # an operator action on the journal and poison files: no dataset
        return _run_unpoison(args)
    if _refused(args):
        return 1
    if args.distributed:
        # before any device query: it picks this process's card
        from consensus_entropy_tpu_torch.parallel import multihost

        try:
            coord, n_proc, proc_id = args.distributed.split(",")
            n_proc, proc_id = int(n_proc), int(proc_id)
        except ValueError:
            print(f"--distributed must be COORD,N,ID "
                  f"(got {args.distributed!r})")
            return 1
        if args.mesh != "auto":
            # a numeric mesh would name the same devices in every process,
            # and no mesh would run the whole workload in each
            print("--distributed requires --mesh auto (got "
                  f"--mesh {args.mesh!r})")
            return 1
        multihost.initialize(coord, n_proc, proc_id, device=args.device)
    import numpy as np

    from consensus_entropy_tpu_torch.al import workspace
    from consensus_entropy_tpu_torch.al.loop import ALLoop
    from consensus_entropy_tpu_torch.config import ALConfig, PathsConfig
    from consensus_entropy_tpu_torch.data import amg
    from consensus_entropy_tpu_torch.device import resolve_device
    from consensus_entropy_tpu_torch.models.committee import CNNMember
    from consensus_entropy_tpu_torch.resilience.preemption import (
        EXIT_PREEMPTED,
        Preempted,
        PreemptionGuard,
    )

    # the fabric coordinator never scores: it leaves the device (and
    # CUDA) to its workers
    coordinator = args.hosts is not None
    device = None if coordinator else resolve_device(args.device)
    paths = PathsConfig(models_root=args.models_root,
                        amg_root=args.amg_root)
    cfg = ALConfig(queries=args.queries, epochs=args.epochs, mode=args.mode,
                   num_anno=args.num_anno, seed=args.seed,
                   qbdc_k=args.qbdc_k,
                   consensus_weighting=args.consensus_weighting)
    if not os.path.isdir(paths.pretrained_dir):
        print("No pre-trained models of this type!  Run deam-classifier "
              f"first (looked in {paths.pretrained_dir}).")
        return 1
    try:
        files = workspace.member_files(paths.pretrained_dir)
        cnn_cfg = resolve_cnn_config(args.cnn_config_json,
                                     arch=args.cnn_arch)
    except (workspace.UnportedMemberError, ValueError) as e:
        print(f"cannot personalize this registry: {e}")
        return 1
    if args.full_song_hop is not None and not (
            1 <= args.full_song_hop <= cnn_cfg.input_length):
        print(f"--full-song-hop must be in [1, input_length="
              f"{cnn_cfg.input_length}], got {args.full_song_hop}")
        return 1
    has_cnn = any(CNNMember.stem_of(f) for f in files)
    if args.mode == "qbdc" and not has_cnn:
        # the dropout committee is K masked forwards of a CNN member
        print("--al-mode qbdc needs pre-trained CNN members (no "
              f"classifier_cnn.*.npz in {paths.pretrained_dir}); run "
              "deam-classifier with a CNN registry first")
        return 1
    if args.mode == "qbdc" and args.mesh and args.fleet is None \
            and args.serve is None:
        # the sequential path's qbdc forward is one member's, unsharded
        print("--al-mode qbdc does not support --mesh (qbdc scoring is "
              "single-mesh only; use --fleet/--serve to batch users)")
        return 1

    anno = amg.load_annotations(paths.amg_annotations_mat,
                                paths.amg_mapping_mat)
    hc_table = amg.hc_frequency_table(anno)
    anno, users = amg.filter_users(anno, cfg.num_anno)
    print(f"Users with more than {cfg.num_anno} annotations: {len(users)}")
    pool = amg.load_feature_pool(paths.amg_dataset_csv,
                                 paths.amg_features_dir)
    store = None
    if has_cnn and not coordinator:
        from consensus_entropy_tpu_torch.data.audio import (
            device_store_from_npy,
        )

        # CNN scoring and retraining crop from the device store
        store = device_store_from_npy(paths.amg_npy_dir, pool.song_ids,
                                      cnn_cfg.input_length, device)
    mesh = train_mesh = loop = None
    if not coordinator:
        meshes = _meshes(args, device, store)
        if meshes is None:
            return 1
        mesh, train_mesh = meshes
        loop = ALLoop(cfg, tie_break=args.tie_break,
                      retrain_epochs=args.retrain_epochs,
                      pad_pool_to=args.pad_pool_to,
                      fuse_step=not args.no_fuse_step, device=device,
                      mesh=mesh)
    results = []
    try:
        with PreemptionGuard() as guard:
            _run_users(args, cfg, paths, users, pool, anno, hc_table,
                       store, cnn_cfg, loop, guard, device, results,
                       mesh, train_mesh)
    except Preempted as e:
        print(f"preempted: {e}")
        return EXIT_PREEMPTED
    if results:
        finals = [r["final_mean_f1"] for r in results]
        print(f"\n{len(results)} users; final committee F1 "
              f"mu={np.mean(finals):.4f} sigma={np.std(finals):.4f}")
    return 0


def _meshes(args, device, store):
    """``(mesh, train_mesh)`` of ``--mesh`` (``(None, None)`` without it),
    or ``None`` after printing why the flag is refused.  The sequential
    path with CNN members also spreads the retrain's members over a member
    axis of the same devices."""
    if not args.mesh:
        return None, None
    from consensus_entropy_tpu_torch.parallel import multihost
    from consensus_entropy_tpu_torch.parallel.mesh import (
        make_pool_mesh,
        make_training_mesh,
    )
    from consensus_entropy_tpu_torch.parallel.pool_mesh import (
        make_pool_mesh_for,
    )

    have = (1 if device.type == "cpu" else _cuda_count())
    try:
        n_dev = have if args.mesh == "auto" else int(args.mesh)
    except ValueError:
        n_dev = None
    if n_dev is None:
        # an explicit device list, which may repeat a device
        try:
            mesh = make_pool_mesh(args.mesh.split(","))
        except (ValueError, RuntimeError) as e:
            print(f"--mesh must be 'auto', a device count or a device "
                  f"list, got {args.mesh!r}: {e}")
            return None
    elif device.type == "cpu" and n_dev >= 1:
        mesh = make_pool_mesh_for(n_dev, "cpu")
    elif not 1 <= n_dev <= have:
        print(f"--mesh {args.mesh}: have {have} device(s)")
        return None
    elif args.distributed:
        # this process's card; the process group holds the others
        mesh = multihost.global_pool_mesh()
    else:
        mesh = make_pool_mesh_for(n_dev)
    if args.distributed:
        print(f"Scoring mesh: {mesh.size} device(s) in each of "
              f"{multihost.process_count()} process(es) on the pool axis")
    else:
        print(f"Scoring mesh: {mesh.size} device(s) on the pool axis")
    train_mesh = None
    if store is not None and args.fleet is None and args.serve is None:
        train_mesh = make_training_mesh(dp=1, member=mesh.size,
                                        devices=mesh.device_list)
        print(f"Training mesh: {mesh.size} device(s) on the member axis")
    return mesh, train_mesh


def _cuda_count() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _run_users(args, cfg, paths, users, pool, anno, hc_table, store,
               cnn_cfg, loop, guard, device, results, mesh=None,
               train_mesh=None) -> None:
    from consensus_entropy_tpu_torch.al import workspace
    from consensus_entropy_tpu_torch.al.loop import UserData
    from consensus_entropy_tpu_torch.data import amg
    from consensus_entropy_tpu_torch.obs.metrics import StepTimer
    from consensus_entropy_tpu_torch.obs.trace import device_trace
    from consensus_entropy_tpu_torch.parallel import multihost
    from consensus_entropy_tpu_torch.resilience.preemption import Preempted

    if args.fleet is not None:
        _run_users_fleet(args, cfg, paths, users, pool, anno, hc_table,
                         store, cnn_cfg, guard, device, results, mesh)
        return
    if args.fabric_worker is not None:
        _run_users_fabric_worker(args, cfg, paths, users, pool, anno,
                                 hc_table, store, cnn_cfg, guard, device,
                                 mesh)
        return
    if args.hosts is not None:
        _run_users_fabric(args, cfg, paths, users, pool, anno, guard)
        return
    if args.serve is not None:
        _run_users_serve(args, cfg, paths, users, pool, anno, hc_table,
                         store, cnn_cfg, guard, device, results, mesh)
        return
    # several processes: the coordinator owns every workspace write, and
    # the decisions that steer control flow are agreed by all (a process
    # that diverged would hang the next collective)
    for num_user, u_id in enumerate(users[: args.max_users]):
        if multihost.broadcast_flag(guard.requested):
            raise Preempted(f"stopping before user {u_id}")
        if multihost.is_coordinator():
            user_path, skip = workspace.create_user(
                paths.users_dir, paths.pretrained_dir, u_id, cfg.mode,
                experiment={"seed": cfg.seed, "queries": cfg.queries,
                            "train_size": cfg.train_size})
        else:
            user_path = workspace.user_dir(paths.users_dir, u_id, cfg.mode)
            skip = False
        multihost.sync(f"create_user_{num_user}")
        if multihost.broadcast_flag(skip):
            print(f"Skipping user {u_id}, already exists!")
            continue
        committee = workspace.load_committee(
            user_path, cnn_cfg, device_members=args.device_members,
            full_song_hop=args.full_song_hop, device=device, mesh=mesh,
            train_mesh=train_mesh)
        sub_pool, labels = amg.user_pool(pool, anno, u_id)
        data = UserData(u_id, sub_pool, labels,
                        hc_rows=hc_table.rows_for(sub_pool.song_ids),
                        store=store)
        print(f"Creating and performing active learning for user {u_id} "
              f"with {len(labels)} annotations.")
        print(f"User {num_user} / {len(users) - 1}")
        timer = StepTimer(os.path.join(user_path, "timings.jsonl")
                          if multihost.is_coordinator() else None)
        with device_trace(args.trace_dir, device):
            res = loop.run_user(committee, data, user_path, seed=cfg.seed,
                                timer=timer, preemption=guard)
        if multihost.is_coordinator():
            committee.save(user_path)
            workspace.mark_done(user_path)
        multihost.sync(f"user_done_{num_user}")
        results.append(res)
        print(f"user {u_id}: final mean F1 = {res['final_mean_f1']:.4f}")


def _run_users_fleet(args, cfg, paths, users, pool, anno, hc_table, store,
                     cnn_cfg, guard, device, results, mesh=None) -> None:
    """The fleet path: cohorts of ``--fleet N`` users through
    ``fleet.FleetScheduler`` on ``device`` (on ``mesh``, every pool split
    across it: users times shards in one dispatch), each user's workspace
    and result the sequential path's."""
    import json

    from consensus_entropy_tpu_torch.fleet import (
        FleetReport,
        FleetScheduler,
    )
    from consensus_entropy_tpu_torch.fleet.report import bench_line

    report = FleetReport(os.path.join(paths.users_dir,
                                      "fleet_metrics.jsonl"))
    tracer = _build_tracer(args, cfg, paths)
    scheduler = FleetScheduler(
        cfg, tie_break=args.tie_break, retrain_epochs=args.retrain_epochs,
        host_workers=args.fleet_host_workers, preemption=guard,
        pad_pool_to=args.pad_pool_to, report=report,
        stack_cnn=not args.no_stack_cnn, plan_chunk=args.plan_chunk,
        fuse_step=not args.no_fuse_step, device=device, mesh=mesh,
        tracer=tracer, profile_dir=args.torch_profile,
        profile_n=args.torch_profile_n)
    todo = list(users[: args.max_users])
    failed = []
    try:
        _run_fleet_cohorts(args, cfg, paths, store, pool, anno, hc_table,
                           cnn_cfg, device, scheduler, todo, results,
                           failed)
    finally:
        # the run span closes on preemption too (a rerun reuses the ids)
        tracer.close()
    summary = report.write_summary(cohort=min(args.fleet, len(todo) or 1))
    report.close()
    print("fleet summary: " + json.dumps(bench_line(summary),
                                         sort_keys=True))
    if failed:
        # as the sequential path crashes on a user's error, a fleet run
        # that dropped users must not look successful
        raise RuntimeError(
            f"{len(failed)} fleet user(s) failed terminally after "
            f"eviction/resume: {failed}")


def _run_fleet_cohorts(args, cfg, paths, store, pool, anno, hc_table,
                       cnn_cfg, device, scheduler, todo, results,
                       failed) -> None:
    from consensus_entropy_tpu_torch.al import workspace
    from consensus_entropy_tpu_torch.al.loop import UserData
    from consensus_entropy_tpu_torch.data import amg
    from consensus_entropy_tpu_torch.fleet import FleetUser

    experiment = {"seed": cfg.seed, "queries": cfg.queries,
                  "train_size": cfg.train_size}
    for lo in range(0, len(todo), args.fleet):
        cohort = todo[lo: lo + args.fleet]
        entries = []
        for u_id in cohort:
            user_path, skip = workspace.create_user(
                paths.users_dir, paths.pretrained_dir, u_id, cfg.mode,
                experiment=experiment)
            if skip:
                print(f"Skipping user {u_id}, already exists!")
                continue

            def factory(user_path=user_path):
                return workspace.load_committee(
                    user_path, cnn_cfg, device_members=args.device_members,
                    full_song_hop=args.full_song_hop, device=device)

            sub_pool, labels = amg.user_pool(pool, anno, u_id)
            data = UserData(u_id, sub_pool, labels,
                            hc_rows=hc_table.rows_for(sub_pool.song_ids),
                            store=store)
            entries.append(FleetUser(u_id, factory(), data, user_path,
                                     seed=cfg.seed,
                                     committee_factory=factory))
        if not entries:
            continue
        print(f"Fleet cohort of {len(entries)} users "
              f"({lo}..{lo + len(cohort) - 1} of {len(todo)})")
        for rec in scheduler.run(entries):
            if rec["error"] is not None:
                print(f"user {rec['user']} FAILED: {rec['error']}")
                failed.append(rec["user"])
                continue
            user_path = workspace.user_dir(paths.users_dir, rec["user"],
                                           cfg.mode)
            rec["committee"].save(user_path)
            workspace.mark_done(user_path)
            results.append(rec["result"])
            print(f"user {rec['user']}: final mean F1 = "
                  f"{rec['result']['final_mean_f1']:.4f}")


def _mesh_width(spec: str) -> int | None:
    """The device count a ``--mesh`` spelling names (None for ``auto`` or
    a malformed one, which the mesh builder reports)."""
    try:
        return int(spec)
    except ValueError:
        return len(spec.split(",")) if "," in spec or ":" in spec else None


def _refused(args) -> bool:
    """The JAX CLI's refusals of fleet and serve flags
    (``amg_test.py:388-470``, their order and words), minus the fabric's;
    prints the reason and returns True for a refused combination."""
    if args.fleet is not None and args.serve is not None:
        print("--fleet and --serve are exclusive: --fleet runs fixed "
              "cohorts, --serve runs continuous admission")
        return True
    if args.fleet is not None or args.serve is not None:
        n_flag, n_val = (("--fleet", args.fleet) if args.fleet is not None
                         else ("--serve", args.serve))
        if n_val < 1:
            print(f"{n_flag} must be >= 1, got {n_val}")
            return True
        if args.distributed:
            # mesh x users composes in one process; several processes
            # stacking one cohort are not built
            print(f"{n_flag} is single-process only (drop --distributed)")
            return True
        if args.mesh == "auto":
            print(f"{n_flag} shards pools on an explicit mesh width "
                  "(--mesh N) — 'auto' is the sequential path's spelling")
            return True
    if args.serve is not None and args.pad_pool_to is not None:
        print("--serve pads per bucket; use --bucket-widths instead of "
              "--pad-pool-to")
        return True
    if args.no_stack_cnn and args.fleet is None and args.serve is None:
        print("--no-stack-cnn requires --fleet or --serve (the sequential "
              "path never stacks)")
        return True
    if args.plan_chunk is not None and (
            args.plan_chunk < 1 or (args.fleet is None
                                    and args.serve is None)):
        print("--plan-chunk takes a positive chunk size and requires "
              "--fleet or --serve")
        return True
    if args.admit_window_ms and args.serve is None:
        print("--admit-window-ms requires --serve")
        return True
    if args.torch_profile is not None and args.fleet is None \
            and args.serve is None:
        print("--torch-profile captures the engine's device dispatches; it "
              "requires --fleet or --serve (use --trace-dir for sequential "
              "runs)")
        return True
    if args.torch_profile is not None and args.hosts is not None:
        # fabric workers would race each other's profile files in one DIR
        print("--torch-profile is single-process (drop --hosts)")
        return True
    if args.torch_profile_n < 1:
        print(f"--torch-profile-n must be >= 1, got {args.torch_profile_n}")
        return True
    for flag, is_set in (("--no-serve-journal", args.no_serve_journal),
                         ("--no-slo-planner", args.no_slo_planner),
                         ("--slo-interactive-s",
                          args.slo_interactive_s != 60.0),
                         ("--slo-batch-s", args.slo_batch_s != 600.0),
                         ("--priority-aging-s",
                          args.priority_aging_s != 30.0),
                         ("--interactive-users",
                          args.interactive_users is not None),
                         ("--watchdog-s", args.watchdog_s),
                         ("--failure-budget", args.failure_budget != 3),
                         ("--breaker-threshold",
                          args.breaker_threshold != 2),
                         ("--breaker-cooldown-s",
                          args.breaker_cooldown_s != 30.0),
                         ("--breaker-probes", args.breaker_probes != 0),
                         ("--journal-compact-kb",
                          args.journal_compact_kb != 0),
                         ("--hosts", args.hosts is not None),
                         ("--lease-s", args.lease_s != 5.0),
                         ("--min-hosts", args.min_hosts is not None),
                         ("--max-hosts", args.max_hosts is not None),
                         ("--scale-down-s", args.scale_down_s != 0.0)):
        if is_set and args.serve is None:
            print(f"{flag} requires --serve")
            return True
    if args.qbdc_k < 1:
        print(f"--qbdc-k must be >= 1, got {args.qbdc_k}")
        return True
    if args.serve is not None and (args.watchdog_s < 0
                                   or args.failure_budget < 1
                                   or args.breaker_threshold < 0
                                   or args.breaker_probes < 0
                                   or args.journal_compact_kb < 0):
        print("--watchdog-s must be >= 0, --failure-budget >= 1, "
              "--breaker-threshold >= 0, --breaker-probes >= 0, "
              "--journal-compact-kb >= 0")
        return True
    if args.serve is not None and (args.slo_interactive_s <= 0
                                   or args.slo_batch_s <= 0
                                   or args.priority_aging_s < 0):
        print("--slo-interactive-s and --slo-batch-s must be > 0, "
              "--priority-aging-s >= 0")
        return True
    if _fabric_refused(args):
        return True
    args._bucket_widths = None
    if args.bucket_widths is not None:
        if args.serve is None:
            print("--bucket-widths requires --serve")
            return True
        try:
            widths = tuple(int(w) for w in args.bucket_widths.split(",")
                           if w)
            if not widths:
                raise ValueError
        except ValueError:
            print(f"--bucket-widths must be comma-separated positive ints, "
                  f"got {args.bucket_widths!r}")
            return True
        from consensus_entropy_tpu_torch.serve.buckets import (
            validate_bucket_widths,
        )

        try:
            validate_bucket_widths(widths)
        except ValueError as e:
            print(f"--bucket-widths {args.bucket_widths!r} is invalid: "
                  f"{e}")
            return True
        args._bucket_widths = widths
    if args.serve is not None and args.mesh \
            and _mesh_width(args.mesh) is not None:
        # an edge that does not divide across the pool mesh fails here,
        # not as a shard mismatch at the first dispatch
        from consensus_entropy_tpu_torch.serve import ServeConfig

        try:
            ServeConfig(target_live=args.serve,
                        bucket_widths=args._bucket_widths,
                        mesh_devices=_mesh_width(args.mesh))
        except ValueError as e:
            print(f"--mesh {args.mesh} is invalid with this serve "
                  f"config: {e}")
            return True
    return False


def _fabric_refused(args) -> bool:
    """The JAX CLI's fabric and alert-sink refusals (``amg_test.py:
    482-563``, their order and words); builds ``args._fabric_config`` for
    ``--hosts``.  Every ``--alert-sink`` spec is parsed here, before any
    work starts."""
    args._fabric_config = None
    if args.hosts is not None:
        if args.hosts < 1 or args.lease_s <= 0:
            print("--hosts must be >= 1 and --lease-s > 0")
            return True
        if args.no_serve_journal:
            print("--hosts requires the admission journal (it is the "
                  "fabric's source of truth); drop --no-serve-journal")
            return True
        from consensus_entropy_tpu_torch.serve import FabricConfig

        if args.mesh_devices is not None and args.mesh:
            print("--mesh-devices and --mesh are two spellings of the "
                  "same fleet shape: give the fabric --mesh-devices "
                  "(per-host) OR --mesh N (fleet-wide), not both")
            return True
        mesh_devices = _mesh_width(args.mesh) or 1 if args.mesh else 1
        if args.mesh_devices is not None:
            try:
                parts = tuple(int(x) for x in
                              str(args.mesh_devices).split(",")
                              if x.strip())
                if not parts:
                    raise ValueError
            except ValueError:
                print(f"--mesh-devices must be an int or comma-separated "
                      f"ints, got {args.mesh_devices!r}")
                return True
            mesh_devices = parts[0] if len(parts) == 1 else parts
        try:
            args._fabric_config = FabricConfig(
                hosts=args.hosts, lease_s=args.lease_s,
                mesh_devices=mesh_devices,
                min_hosts=args.min_hosts, max_hosts=args.max_hosts,
                scale_down_s=args.scale_down_s,
                drain_host=args.drain_host,
                placement=args.placement,
                fence_deadline_s=args.fence_deadline_s,
                remedy=args.remedy,
                remedy_hold_s=args.remedy_hold_s,
                remedy_cooldown_s=args.remedy_cooldown_s,
                **({} if args.remedy_skew is None
                   else {"remedy_skew": args.remedy_skew}),
                # the fleet planner must not fight explicit operator
                # edges or a disabled local planner
                fleet_planner=(not args.no_slo_planner
                               and args.bucket_widths is None))
        except ValueError as e:
            print(f"invalid fabric config: {e}")
            return True
    elif args.min_hosts is not None or args.max_hosts is not None \
            or args.scale_down_s or args.drain_host is not None \
            or args.fence_deadline_s or args.remedy \
            or args.mesh_devices is not None:
        print("--min-hosts/--max-hosts/--scale-down-s/--drain-host/"
              "--fence-deadline-s/--remedy/--mesh-devices require "
              "--hosts (the elastic fabric scales a multi-host fleet)")
        return True
    if args.alert_sink:
        if args.no_introspection:
            print("--alert-sink needs the introspection plane; drop "
                  "--no-introspection")
            return True
        # a mistyped spec fails here with its reason, not as an alert
        # dropped minutes into a run
        from consensus_entropy_tpu_torch.obs.alerts import make_sink

        try:
            for spec in args.alert_sink:
                make_sink(spec)
        except ValueError as e:
            print(f"invalid --alert-sink: {e}")
            return True
    if args.fabric_worker is not None and (args.fabric_dir is None
                                           or args.serve is None):
        print("--fabric-worker is internal (spawned by --hosts) and "
              "needs --fabric-dir and --serve")
        return True
    return False


def _serve_config(args, mesh=None):
    """The ``ServeConfig`` of the serve flags (``amg_test.py:771`` of the
    JAX CLI); a pool mesh sets its width."""
    from consensus_entropy_tpu_torch.serve import ServeConfig

    return ServeConfig(
        target_live=args.serve,
        admit_window_s=args.admit_window_ms / 1000.0,
        bucket_widths=args._bucket_widths,
        mesh_devices=mesh.size if mesh is not None else 1,
        watchdog_s=args.watchdog_s,
        failure_budget=args.failure_budget,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_s,
        breaker_probes=args.breaker_probes,
        slo_planner=not args.no_slo_planner,
        slo_interactive_s=args.slo_interactive_s,
        slo_batch_s=args.slo_batch_s,
        aging_s=args.priority_aging_s)


def _interactive_set(args) -> set:
    """The user ids of ``--interactive-users`` (everyone else is
    ``batch``)."""
    if not args.interactive_users:
        return set()
    return {u.strip() for u in args.interactive_users.split(",")
            if u.strip()}


def _introspection(args, paths, host, report, log=None):
    """The operator plane's limbs for one process (``amg_test.py:804-819``
    of the JAX CLI): a ``status_<host>.json`` writer under
    ``users/status/`` and an alert watcher emitting schema ``alert``
    events through ``report`` and every ``--alert-sink`` (plus ``log``:
    the coordinator passes ``print``, so alerts reach its console).
    ``(None, None)`` under ``--no-introspection``."""
    if args.no_introspection:
        return None, None
    from consensus_entropy_tpu_torch.obs.alerts import AlertWatcher, make_sink
    from consensus_entropy_tpu_torch.obs.status import StatusWriter

    status = StatusWriter(os.path.join(paths.users_dir, "status"), host)
    sinks = tuple(make_sink(spec, log=log)
                  for spec in (args.alert_sink or ()))
    return status, AlertWatcher(report, log=log, sinks=sinks)


def _build_tracer(args, cfg, paths, *, path=None, host=None):
    """The span tracer of fleet, serve and fabric runs: ``spans.jsonl`` in
    ``--trace-dir`` or the users directory (a fabric worker's ``path`` is
    its span WAL).  Its run id comes from mode and seed, so a restarted
    run, and every worker of one fabric, continue the same traces."""
    from consensus_entropy_tpu_torch.obs.trace import Tracer

    if path is None:
        path = os.path.join(args.trace_dir or paths.users_dir,
                            "spans.jsonl")
    return Tracer(path, run_id=f"{cfg.mode}-{cfg.seed}", host=host,
                  enabled=not args.no_trace)


def _run_users_serve(args, cfg, paths, users, pool, anno, hc_table, store,
                     cnn_cfg, guard, device, results, mesh=None) -> None:
    """The serve path: continuous admission through ``serve.FleetServer``
    on ``device``, ``--serve N`` sessions live, each user padded to its
    bucket; each user's workspace and result are the sequential path's,
    persisted the moment the user finishes.  Admission transitions go
    through ``users/serve_journal.jsonl`` (unless ``--no-serve-journal``):
    a killed run restarted with the same flags re-admits in-flight users
    first, re-queues waiting ones in order and skips finished ones; users
    past ``--failure-budget`` are in ``users/serve_poison.jsonl`` and
    skipped on every run."""
    import json

    from consensus_entropy_tpu_torch.al import workspace
    from consensus_entropy_tpu_torch.al.loop import UserData
    from consensus_entropy_tpu_torch.data import amg
    from consensus_entropy_tpu_torch.fleet import (
        FleetReport,
        FleetScheduler,
        FleetUser,
    )
    from consensus_entropy_tpu_torch.fleet.report import bench_line
    from consensus_entropy_tpu_torch.serve import (
        AdmissionJournal,
        FleetServer,
        PoisonList,
    )

    experiment = {"seed": cfg.seed, "queries": cfg.queries,
                  "train_size": cfg.train_size}
    report = FleetReport(os.path.join(paths.users_dir,
                                      "fleet_metrics.jsonl"))
    journal = None if args.no_serve_journal else AdmissionJournal(
        os.path.join(paths.users_dir, "serve_journal.jsonl"),
        compact_bytes=args.journal_compact_kb * 1024 or None)
    poison = PoisonList(os.path.join(paths.users_dir,
                                     "serve_poison.jsonl"))
    tracer = _build_tracer(args, cfg, paths)
    scheduler = FleetScheduler(
        cfg, tie_break=args.tie_break, retrain_epochs=args.retrain_epochs,
        host_workers=args.fleet_host_workers, report=report,
        scoring_by_width=True, stack_cnn=not args.no_stack_cnn,
        plan_chunk=args.plan_chunk, fuse_step=not args.no_fuse_step,
        device=device, mesh=mesh, tracer=tracer,
        profile_dir=args.torch_profile, profile_n=args.torch_profile_n)
    status, alerts = _introspection(args, paths, "local", report)
    server = FleetServer(scheduler, _serve_config(args, mesh),
                         preemption=guard, journal=journal, poison=poison,
                         status=status, alerts=alerts)
    todo = list(users[: args.max_users])
    if journal is not None and journal.recovered:
        st = journal.state
        # in-flight users first (their workspaces hold the most sunk
        # work), then journal-queued users in order, then new ones
        todo = st.recovery_order(todo)
        print(f"serve journal: recovering — {len(st.finished)} finished "
              f"(skipped), {len(st.in_flight)} in-flight (re-admitted "
              f"first), {len(st.queued)} queued (re-enqueued), "
              f"{len(st.poisoned)} poisoned")
    interactive = _interactive_set(args)

    def source():
        # pulled as queue room frees: each user's workspace and committee
        # are made just in time, and a drain leaves the rest untouched
        for u_id in todo:
            user_path, skip = workspace.create_user(
                paths.users_dir, paths.pretrained_dir, u_id, cfg.mode,
                experiment=experiment)
            if skip:
                print(f"Skipping user {u_id}, already exists!")
                continue

            def factory(user_path=user_path):
                return workspace.load_committee(
                    user_path, cnn_cfg, device_members=args.device_members,
                    full_song_hop=args.full_song_hop, device=device)

            sub_pool, labels = amg.user_pool(pool, anno, u_id)
            data = UserData(u_id, sub_pool, labels,
                            hc_rows=hc_table.rows_for(sub_pool.song_ids),
                            store=store)
            yield FleetUser(u_id, factory(), data, user_path,
                            seed=cfg.seed, committee_factory=factory,
                            priority="interactive"
                            if str(u_id) in interactive else "batch")

    failed = []

    def on_result(rec):
        # a finished user is durable at once, not at the end of the run
        if rec["error"] is not None:
            print(f"user {rec['user']} FAILED: {rec['error']}")
            failed.append(rec["user"])
            return
        user_path = workspace.user_dir(paths.users_dir, rec["user"],
                                       cfg.mode)
        rec["committee"].save(user_path)
        workspace.mark_done(user_path)
        results.append(rec["result"])
        print(f"user {rec['user']}: final mean F1 = "
              f"{rec['result']['final_mean_f1']:.4f}")

    try:
        server.serve(source(), on_result=on_result)
    finally:
        tracer.close()
        summary = report.write_summary(cohort=args.serve)
        report.close()
        print("serve summary: "
              + json.dumps(bench_line(summary), sort_keys=True))
        if summary.get("users_failed") or len(poison):
            print(f"serve failures: {summary.get('users_failed', 0)} "
                  f"user(s) failed terminally, {len(poison)} on the "
                  f"poison list ({poison.path})")
        if scheduler.profile_path is not None:
            print(f"device profile: {scheduler.profile_path}")
        if journal is not None:
            journal.close()
        poison.close()
    if failed:
        # as the sequential path crashes on a user's error, a serve run
        # that dropped users must not look successful
        raise RuntimeError(
            f"{len(failed)} serve user(s) failed terminally after "
            f"eviction/resume: {failed}")


def _pool_sizes(pool, anno, users) -> dict:
    """Each user's enqueue-time pool size (annotated songs in the feature
    pool), journaled on ``enqueue`` so bucket-aware placement co-locates
    same-bucket users as a pure function of the journal."""
    pool_songs = set(pool.song_ids)
    sizes = {}
    for u in users:
        mine = set(anno.song_id[anno.user_id == u].tolist())
        sizes[str(u)] = sum(1 for s in mine if s in pool_songs)
    return sizes


def _run_users_fabric(args, cfg, paths, users, pool, anno, guard) -> None:
    """The fabric coordinator (``amg_test.py:1124-1265`` of the JAX CLI):
    shard the users across ``--hosts`` worker processes, each this CLI
    re-run with ``--fabric-worker``, coordinated through the admission
    journal (``serve.fabric``).  The coordinator owns the journal, the
    routing and the failover and never touches the device; the workers
    own the engines and the per-user persistence."""
    import json
    import subprocess

    from consensus_entropy_tpu_torch.fleet import FleetReport
    from consensus_entropy_tpu_torch.serve import (
        AdmissionJournal,
        FabricCoordinator,
        PoisonList,
    )
    from consensus_entropy_tpu_torch.serve.hosts import fabric_paths

    fabric_dir = os.path.join(paths.users_dir, "fabric")
    os.makedirs(fabric_dir, exist_ok=True)
    journal = AdmissionJournal(
        os.path.join(paths.users_dir, "serve_journal.jsonl"),
        compact_bytes=args.journal_compact_kb * 1024 or None)
    poison = PoisonList(os.path.join(paths.users_dir,
                                     "serve_poison.jsonl"))
    report = FleetReport(os.path.join(paths.users_dir,
                                      "fleet_metrics.jsonl"))
    worker_argv = _worker_argv(args._raw_argv)
    # workers import this package whatever their working directory
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = pkg_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    fabric_cfg = args._fabric_config

    def spawn(host_id):
        # a host of K devices serves on a K-entry pool mesh: K times the
        # one card (or the CPU under --device cpu); --device passes
        # through unchanged in worker_argv
        digits = "".join(ch for ch in host_id if ch.isdigit())
        n_dev = fabric_cfg.devices_for(int(digits) if digits else 0)
        mesh_argv = []
        if n_dev > 1:
            one = "cpu" if args.device == "cpu" else "cuda:0"
            mesh_argv = ["--mesh", ",".join([one] * n_dev)]
        log = open(fabric_paths(fabric_dir, host_id)["log"], "ab")
        try:
            # fork then exec: the coordinator holds no CUDA state to share
            return subprocess.Popen(
                [sys.executable, "-m",
                 "consensus_entropy_tpu_torch.cli.amg_test", *worker_argv,
                 *mesh_argv, "--fabric-worker", host_id,
                 "--fabric-dir", fabric_dir],
                stdout=log, stderr=subprocess.STDOUT, env=env)
        finally:
            log.close()  # the child holds its own descriptor

    # the coordinator's tracer owns spans.jsonl; the workers' span WALs
    # (fabric/spans_<h>.jsonl) are transcribed into it
    tracer = _build_tracer(args, cfg, paths, host="coordinator")
    status, alerts = _introspection(args, paths, "coordinator", report,
                                    log=print)
    coord = FabricCoordinator(
        journal, fabric_dir, fabric_cfg, poison=poison, report=report,
        preemption=guard, tracer=tracer, status=status, alerts=alerts,
        introspect=not args.no_introspection)
    interactive = _interactive_set(args)
    todo = [str(u) for u in users[: args.max_users]]
    try:
        summary = coord.run(
            todo, spawn, classes={u: "interactive" for u in interactive},
            pools=_pool_sizes(pool, anno, users[: args.max_users]))
    finally:
        tracer.close()
        journal.close()
        poison.close()
        report.close()
    if summary.get("drain_host_unserviced"):
        print(f"WARNING: --drain-host {summary['drain_host_unserviced']} "
              "was never serviced (host never live+joined this run) — "
              "nothing was drained")
    print("fabric summary: " + json.dumps(
        {"users": summary["users"], "finished": len(summary["finished"]),
         "failed": len(summary["failed"]),
         "poisoned": len(summary["poisoned"]),
         "revocations": summary["revocations"],
         "reassignments": summary["reassignments"],
         "spawns": summary["spawns"], "joins": summary["joins"],
         "migrations": summary["migrations"],
         "compactions": summary["compactions"]}, sort_keys=True))
    bad = summary["failed"] + summary["poisoned"]
    if bad:
        raise RuntimeError(
            f"{len(bad)} fabric user(s) failed terminally: {bad}")


#: coordinator-only flags (with a value), stripped from the worker argv
COORDINATOR_FLAGS = ("--hosts", "--min-hosts", "--max-hosts",
                     "--placement", "--scale-down-s", "--drain-host",
                     "--fence-deadline-s", "--remedy-hold-s",
                     "--remedy-cooldown-s", "--remedy-skew",
                     "--mesh-devices", "--mesh")
#: coordinator-only switches (no value)
COORDINATOR_SWITCHES = ("--remedy",)


def _worker_argv(raw_argv) -> list:
    """The coordinator's argv minus its own flags, in both the ``--flag
    value`` and ``--flag=value`` spellings: a surviving ``--min-hosts``
    would fail the worker's own validation (it needs ``--hosts``)."""
    out, skip_next = [], False
    for arg in raw_argv:
        if skip_next:
            skip_next = False
            continue
        if arg in COORDINATOR_FLAGS:
            skip_next = True
            continue
        if arg in COORDINATOR_SWITCHES:
            continue
        if any(arg.startswith(f + "=") for f in COORDINATOR_FLAGS):
            continue
        out.append(arg)
    return out


def _run_users_fabric_worker(args, cfg, paths, users, pool, anno,
                             hc_table, store, cnn_cfg, guard, device,
                             mesh=None) -> None:
    """A fabric worker (``amg_test.py:1266-1352`` of the JAX CLI): one
    serve engine on ``device`` fed from the coordinator's assignment file
    (``serve.hosts.run_worker``); each finished user is persisted the
    moment it finishes, as on the single-host serve path."""
    from consensus_entropy_tpu_torch.al import workspace
    from consensus_entropy_tpu_torch.al.loop import UserData
    from consensus_entropy_tpu_torch.data import amg
    from consensus_entropy_tpu_torch.fleet import (
        FleetReport,
        FleetScheduler,
        FleetUser,
    )
    from consensus_entropy_tpu_torch.serve.hosts import (
        fabric_paths,
        run_worker,
    )

    experiment = {"seed": cfg.seed, "queries": cfg.queries,
                  "train_size": cfg.train_size}
    by_id = {str(u): u for u in users}
    report = FleetReport(os.path.join(
        paths.users_dir, f"fleet_metrics_{args.fabric_worker}.jsonl"))
    # the per-host span WAL the coordinator tails; the shared run id
    # keeps a failed-over user's trace continuous across hosts
    tracer = _build_tracer(
        args, cfg, paths,
        path=fabric_paths(args.fabric_dir, args.fabric_worker)["spans"],
        host=args.fabric_worker)
    scheduler = FleetScheduler(
        cfg, tie_break=args.tie_break, retrain_epochs=args.retrain_epochs,
        host_workers=args.fleet_host_workers, report=report,
        scoring_by_width=True, stack_cnn=not args.no_stack_cnn,
        plan_chunk=args.plan_chunk, fuse_step=not args.no_fuse_step,
        device=device, mesh=mesh, tracer=tracer)

    def build_entry(uid):
        u_id = by_id.get(uid, uid)
        user_path, skip = workspace.create_user(
            paths.users_dir, paths.pretrained_dir, u_id, cfg.mode,
            experiment=experiment)
        if skip:
            print(f"Skipping user {u_id}, already exists!")
            return None

        def factory(user_path=user_path):
            return workspace.load_committee(
                user_path, cnn_cfg, device_members=args.device_members,
                full_song_hop=args.full_song_hop, device=device)

        sub_pool, labels = amg.user_pool(pool, anno, u_id)
        data = UserData(u_id, sub_pool, labels,
                        hc_rows=hc_table.rows_for(sub_pool.song_ids),
                        store=store)
        return FleetUser(u_id, factory(), data, user_path, seed=cfg.seed,
                         committee_factory=factory)

    def on_result(rec):
        if rec["error"] is not None:
            print(f"user {rec['user']} FAILED: {rec['error']}")
            return
        user_path = workspace.user_dir(paths.users_dir, rec["user"],
                                       cfg.mode)
        rec["committee"].save(user_path)
        workspace.mark_done(user_path)
        print(f"user {rec['user']}: final mean F1 = "
              f"{rec['result']['final_mean_f1']:.4f}")

    status, alerts = _introspection(args, paths, args.fabric_worker,
                                    report)
    try:
        run_worker(
            args.fabric_dir, args.fabric_worker, build_entry=build_entry,
            scheduler=scheduler, config=_serve_config(args, mesh),
            on_result=on_result, lease_s=args.lease_s, preemption=guard,
            status=status, alerts=alerts)
    finally:
        tracer.close()
        # this host's summary carries its admission-to-finish latencies
        report.write_summary(cohort=args.serve)
        report.close()


def _run_unpoison(args) -> int:
    """``--unpoison``: journaled removal from the poison list, plus an
    ``unpoison`` record in the admission journal so a restart forgets the
    user's spent failure budget."""
    from consensus_entropy_tpu_torch.config import PathsConfig
    from consensus_entropy_tpu_torch.serve import (
        AdmissionJournal,
        PoisonList,
        SingleWriterViolation,
    )

    paths = PathsConfig(models_root=args.models_root,
                        amg_root=args.amg_root)
    ppath = os.path.join(paths.users_dir, "serve_poison.jsonl")
    jpath = os.path.join(paths.users_dir, "serve_journal.jsonl")
    poison = PoisonList(ppath)
    journal = AdmissionJournal(jpath) if os.path.exists(jpath) else None
    rc = 0
    try:
        for uid in filter(None, (u.strip()
                                 for u in args.unpoison.split(","))):
            if poison.remove(uid):
                if journal is not None:
                    journal.append("unpoison", uid)
                print(f"unpoisoned user {uid} (failure budget reset)")
            else:
                print(f"user {uid} is not on the poison list ({ppath})")
                rc = 1
    except SingleWriterViolation as e:
        # a live server owns the WAL: refuse rather than interleave seqs
        print(f"cannot unpoison while a server is running: {e}")
        rc = 1
    finally:
        poison.close()
        if journal is not None:
            journal.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())
