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
The serve and fabric modes of the JAX CLI (``--mesh-devices``,
``--hosts``) are not ported (ROADMAP A10).
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
    if args.fleet is not None and args.fleet < 1:
        print(f"--fleet must be >= 1, got {args.fleet}")
        return 1
    if args.no_stack_cnn and args.fleet is None:
        print("--no-stack-cnn requires --fleet or --serve (the sequential "
              "path never stacks)")
        return 1
    if args.plan_chunk is not None and (args.plan_chunk < 1
                                        or args.fleet is None):
        print("--plan-chunk takes a positive chunk size and requires "
              "--fleet or --serve")
        return 1
    if args.qbdc_k < 1:
        print(f"--qbdc-k must be >= 1, got {args.qbdc_k}")
        return 1
    if args.fleet is not None:
        if args.distributed:
            # mesh x users composes in one process; several processes
            # stacking one cohort are not built
            print("--fleet is single-process only (drop --distributed)")
            return 1
        if args.mesh == "auto":
            print("--fleet shards pools on an explicit mesh width "
                  "(--mesh N) — 'auto' is the sequential path's spelling")
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

    device = resolve_device(args.device)
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
    if args.mode == "qbdc" and args.mesh and args.fleet is None:
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
    if has_cnn:
        from consensus_entropy_tpu_torch.data.audio import (
            device_store_from_npy,
        )

        # CNN scoring and retraining crop from the device store
        store = device_store_from_npy(paths.amg_npy_dir, pool.song_ids,
                                      cnn_cfg.input_length, device)
    meshes = _meshes(args, device, store)
    if meshes is None:
        return 1
    mesh, train_mesh = meshes
    loop = ALLoop(cfg, tie_break=args.tie_break,
                  retrain_epochs=args.retrain_epochs,
                  pad_pool_to=args.pad_pool_to,
                  fuse_step=not args.no_fuse_step, device=device, mesh=mesh)
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
    if store is not None and args.fleet is None:
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
    from consensus_entropy_tpu_torch.parallel import multihost
    from consensus_entropy_tpu_torch.resilience.preemption import Preempted

    if args.fleet is not None:
        _run_users_fleet(args, cfg, paths, users, pool, anno, hc_table,
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
    scheduler = FleetScheduler(
        cfg, tie_break=args.tie_break, retrain_epochs=args.retrain_epochs,
        host_workers=args.fleet_host_workers, preemption=guard,
        pad_pool_to=args.pad_pool_to, report=report,
        stack_cnn=not args.no_stack_cnn, plan_chunk=args.plan_chunk,
        fuse_step=not args.no_fuse_step, device=device, mesh=mesh)
    todo = list(users[: args.max_users])
    failed = []
    _run_fleet_cohorts(args, cfg, paths, store, pool, anno, hc_table,
                       cnn_cfg, device, scheduler, todo, results, failed)
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


if __name__ == "__main__":
    sys.exit(main())
