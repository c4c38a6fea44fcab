#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --sgd-fold   # one measurement, outside the phases
    python3 chip_smoke.py --serve-drill DIR   # phase 19 (b)'s subprocess

``--sgd-fold`` times one DEAM-scale SGD fold (``-cv 1``) through the host
core and through its Python plain version, members bit-equal, and stops.

Phases, one line of output each (or a few):

1. device — torch/CUDA versions, ``nvidia-smi`` name and power limit;
2. build  — compiles every kernel from ``consensus_entropy_tpu_torch/csrc``
   and counts the tensor-core instructions (``HGMMA``/``HMMA``) in each
   library's SASS;
3. kernel against its plain PyTorch version on the card, small adversarial
   cases (ragged tiles, ties across tiles, masked tiles, fewer valid rows
   than k, a member far below the committee max, other class/frame/member
   counts), with and without the fused top-k, plus a float64 numpy oracle;
   at bench widths the error must also stay under SPLIT_MAX_ERR;
4. the same at full width: M=16 members, N=100,000 songs, K=4 frames,
   F=260 features, C=4 classes, k=10, ~3% of rows masked, under
   SPLIT_MAX_ERR too;
5. the slice: ``LinearPoolScorer(impl="kernel")`` for 10 AL iterations of
   q=10 against ``impl="plain"``, counting kernel launches;
6. times (CUDA events, median of 50 launches; the slice step over 400; its
   merge and mask update per call over 200 back to back) beside two bounds:
   float32 off the tensor cores, and the kernel's own design (3xTF32 on the
   tensor cores, bound by bytes);
7. members: the closed-form committee (8 GaussianNB, 8 SGD-logistic members
   from seeded parameters) scores the same 100,000-song pool on the card,
   held against a float64 numpy oracle (GNB rtol 1e-3 / atol 1e-5, SGD
   rtol 1e-4 / atol 1e-6, tests/test_device_members.py), with its peak
   device memory;
8. acquire: for each of the six modes, an ``Acquirer`` on the card and one
   on the CPU run 10 fused selects on the same probs (the member table, and
   a seeded 20-forward table for qbdc), mc also unfused: equal song ids
   except at near-ties, whose slot values agree within the entropy gate;
   rand ids exactly equal; 10 valid slots each select; equal-weight wmc
   bit-identical to mc on the card, random weights reordering a slot; the
   device masks equal the host masks at the end; no kernel launched;
9. acquisition times: the member pass (CUDA-event median of 50) beside its
   bounds, ms per ``Acquirer.select`` per mode (host clock over 50 selects
   ending in a synchronize, median of 5 rounds), and each mode's device
   busy share over ten selects from ``torch.profiler`` ("not measured" if
   it sees no device time);
10. al-loop: one user's AL loop at the same scale through ``ALLoop.
    run_user`` (8 GaussianNB + 8 SGD members fitted by the port's own
    ``fit`` on seeded labelled sets, scored on the card with
    ``device_members``; q=10, AL_EPOCHS iterations, train size 0.85) for
    mc, hc, mix, rand and wmc, each into a fresh workspace: queried songs
    disjoint, the pool shrinking by q, finite F1s, the committed state,
    iteration 0's selection against the same loop on the CPU (rand ids
    equal; per-slot values within the entropy gate, near-ties counted);
    the median ms of each ``StepTimer`` phase and of the whole iteration,
    and the device busy share over one steady mc iteration (device events
    over the iteration's wall time);
11. al-cli: ``cli.amg_test.main`` end to end on an AMG1608-shaped tree
    this script writes (1608 songs of 4-8 frames, the 260 feature columns,
    ``.mat`` annotations, a registry of 5 GaussianNB + 5 SGD members from
    the port's ``fit``), on the card and on the CPU: equal ``metrics.jsonl``;
    then a run killed by ``CETPU_FAULTS=state.save:kill@2`` and its rerun
    reach the uninterrupted run's metrics and state; then ``-m mc`` and
    ``-m qbdc`` with 2 GBDT and 2 narrow vgg members added to the registry
    and 4-s clips in ``npy/``, and ``-m mc --cnn-arch res --full-song-hop
    16384`` with 2 narrow res members, on the card and the CPU (every
    epoch, finite F1s, state and DONE written; iteration 0's slot values
    within CNN_TOL, near-ties counted);
12. gbdt: the GBDT host core built with g++; one tree and a forest's
    margins at DEAM pre-training scale (108,120 frames x 260 features, 256
    bins, depth 5) bit-equal to the numpy plain versions; an AL member's
    fit, update and pool predict timed;
13. cnn: the vgg CNN at full width (``CNNConfig()``): 5 members x 256
    crops on the card; 2 members x 16 crops, qbdc K=20 and a 3-epoch
    ``fit_many`` against the CPU port (equal crops, masks, permutations and
    dropout keys; scores within CNN_TOL; losses within FIT_TOL; one step's
    gradient within GRAD64_REL_TOL in float64), the log-mel frontend
    against float64; ms per crop per member beside the FLOP bound, ms per
    member-epoch of retraining, peak device memory;
14. al-loop-full: one AMG1608 user (1608 30-s clips on the card, 400
    annotated songs) through ``ALLoop`` with 5 GaussianNB + 5 SGD + 5 GBDT
    + 5 vgg members for mc and qbdc (K=20), FULL_EPOCHS iterations of
    FULL_RETRAIN_EPOCHS retrain epochs: queried songs disjoint, the pool
    shrinking by q, finite F1s, the state committed; the ``StepTimer`` medians and the busy share
    of the traced FULL_PROFILED_MODE iteration; iteration 0 at a narrow
    CNN against the CPU;
15. trunks: res, harm, se1d and musicnn at full width (``CNNConfig(arch=
    a)``), each as phase 13 holds vgg: 5 members from ``init_variables``
    x 256 crops on the card (ms per crop per member beside the trunk's FLOP
    bound, peak device memory); 2 members x 16 crops against the CPU port
    (inference, features and qbdc K=20), one float64 training step's
    gradient (``bw_q``'s too, for harm) and a 1-epoch ``fit_many``; then
    full-song scoring: 5 harm members over 64 seeded clips of 15-30 s on a
    29,524-sample hop (up to 15 windows a song), 8 songs x 2 members
    against the CPU, ms per song; then phase 14's user through ``ALLoop``
    (mc) with 5 GaussianNB + 5 SGD + 2 full-width harm members scoring
    full songs (hop 59,049), 2 iterations of 10 retrain epochs, with the
    ``StepTimer`` medians; no hand kernel launched;
16. fleet: the fleet engine on the card.  (a) the 16 fleet scorer keys
    over FLEET_USERS users' configs[4]-scale tables (N=100,000, M=16, C=4,
    q=10), each row held against that user's own call (bit-equal counted;
    values within the entropy gate, ids equal where values > -inf except
    near-ties), one stacked dispatch timed against FLEET_USERS single calls
    (CUDA events, median of FLEET_REPS); (b) HOST_COHORT AMG1608 users (400
    annotated songs of 6 frames each) with 5 GaussianNB + 5 SGD members,
    mc, FLEET_EPOCHS iterations, through ``FleetScheduler`` with
    FLEET_HOST_WORKERS host workers and through ``ALLoop`` one after
    another, alternated FLEET_ROUNDS times: each user's queried songs, F1s
    and ``al_state.json`` equal; users/s of both, mean device batch,
    occupancy, the device busy share of a traced fleet run and the share
    of its device time that overlaps host steps; (c)
    FULL_COHORT users over phase 14's store with 5 GaussianNB + 5 SGD + 5
    GBDT + 5 vgg members at full width, mc and qbdc (FULL_FLEET_EPOCHS
    iterations of FLEET_RETRAIN retrain epochs), fleet against sequential on
    the card (queried songs equal, F1s within CNN_TOL, bit-equality
    reported; cuDNN held to deterministic algorithms for both), stacked
    dispatches by plan kind, no ``dispatch_failed`` event, wall times, the
    busy share (and host-step overlap) of the traced qbdc fleet run, and
    ``fit_many_users`` against per-user ``fit_many``; (d) ``amg_test
    --fleet 2`` on phase 11's tree on the card and the CPU (run inside
    phase 11, reported here): each user's metrics equal the sequential
    CLI's for its first FLEET_CLI_EPOCHS iterations; no hand kernel
    launched;
17. pretrain: DEAM pre-training and the evidence experiment at DEAM's
    scale (DEAM_SONGS seeded songs of DEAM_FRAMES frames x 260 feature
    columns, annotation tables with NaN tails and length mismatches,
    DEAM_CLIP_S-s clips in ``npy/``, 5.19 GB in the card's store): (a)
    ``load_dataset`` cold (the cache written) and warm, tables equal; (b)
    ``deam_classifier -cv PRE_CV -m gnb`` and ``-m sgd --n-jobs PRE_CV``,
    and the SGD member's host core bit-equal to its Python plain version on
    one one-vs-all problem over every frame (SGD_CHECK_EPOCHS epochs); (c) ``-cv 1 -m xgb`` (100 rounds), the member reloaded from its
    ``.npz`` predicting bit-equal probabilities; (d) ``-cv 1 -m cnn_jax
    --epochs PRE_CNN_EPOCHS`` at full vgg width, ms per epoch and per
    step, the fold F1, then the same fold with ``resume=True``: skipped,
    its file unchanged; (e) ``amg_test`` (PIPELINE_ARGS) on that registry
    over phase 11's tree; (f) ``evidence sweep`` (EVIDENCE_ARGS) on the
    card and on the CPU, every scoring call's slots within the gate,
    trajectories equal (a split only behind a near-tie), then ``evidence
    analyze`` over the card's workdir equal to the sweep's tests; no hand
    kernel launched;
18. mesh: the pool-axis mesh on the one card (every mesh repeats
    ``cuda:0``, so its shards run one after another there: no multi-GPU
    speed is measured).  (a) B2, ``make_shardmap_pallas_mc_scorer`` over
    MESH_B2_SHARDS shards of phase 3's pool: ``linear_mc`` launched once a
    shard (the launches counted from 0 over one sharded select), each
    shard's entropies held against its plain version under SPLIT_MAX_ERR,
    the merged top-k against one unsharded ``linear_score_mc(fuse_topk=
    True)`` (values within the gate, split slots counted as near-ties), the
    CUDA-event median of REPS sharded calls beside the single call's; (b)
    the six fused modes through ``make_sharded_step_fns`` over
    MESH_STEP_SHARDS shards of phases 7-9's tables, MESH_ITERS selects
    each, against the unsharded steps on the card: entropies, values, ids
    and masks bit-equal; (c) ``Committee.predict_song_sequence`` of one
    seeded SEQ_SONG_S-s song at 16 kHz, SEQ_MEMBERS harm members at full
    width (``CNNConfig(arch="harm")``), its windows over SEQ_SHARDS
    shards, against the window grid in one forward
    (``sequence.full_song_probs_reference``) within CNN_TOL, ms per song
    of both, then its first SEQ_HALO_SONG_S s at half-window hop (a halo
    copied from each right neighbour) against the committee's window-grid
    ``predict_songs_cnn`` at that hop; (d) ``amg_test -m mc`` with phase
    11's vgg registry over ``--mesh cuda:0,cuda:0`` and over ``--mesh auto
    --distributed 127.0.0.1:<port>,1,0`` (NCCL at world size 1), on phase
    11's tree and run inside phase 11: the queried songs of phase 11's
    unmeshed card run, every epoch; ``--mesh 2`` refused on one card;
19. serve: single-host serving on the card.  (a) a seeded SERVE_USERS-user
    ``workload`` trace (two priority classes, pools skewed over two bucket
    widths, Poisson arrivals compressed into SERVE_TRACE_S s) played by
    ``TraceDriver(ServerTarget)`` into ``FleetServer(target_live=
    SERVE_LIVE)`` with the SLO planner, the admission journal and the span
    tracer on, each user with phase 16 (b)'s committee (mc, SERVE_EPOCHS
    iterations): each user's metrics and ``al_state.json`` equal its
    sequential run's on the card, ``grade_run`` finds no lost user and a
    clean stream and journal, ``validate_metrics`` is clean, the spans
    have no orphans and export to a Chrome trace; per-class admission wait
    and admission-to-finish p50/p95, the mean bucket occupancy and users/s
    against the sequential runs, by host clock; (b) the same trace in a
    subprocess (``--serve-drill``) killed by
    ``CETPU_FAULTS=serve.journal.append:kill@SERVE_KILL_AT`` mid-run, then
    restarted from the journal: no user lost, the finished users skipped,
    every user's metrics and state equal (a)'s; (c) ``amg_test --serve 2
    --bucket-widths`` with ``--trace-dir`` and ``--torch-profile`` on
    phase 11's GBDT + vgg registry (run inside phase 11): the queried songs
    of the sequential CLI on the same two users, spans without orphans, a
    ``torch.profiler`` trace holding CUDA kernel events; no hand kernel
    launched;
20. fabric: the multi-host serve fabric, ``amg_test --serve 1 --hosts
    2`` run as a subprocess (the coordinator never touches the card; each
    worker is a process of its own on it), on phase 11's tree (run inside
    phase 11, reported here).  (a) FABRIC_USERS users with the GBDT + vgg
    registry placed two a worker; the script tails the journal and
    SIGKILLs h1 (its pid from ``fabric/lease_h1.json``) once h1 has one
    user finished and one in flight: every user finishes once (one
    ``finish`` record each) on the sequential CLI's queried songs, the
    journal validates, the merged spans have no orphans; each worker's
    spawn to first lease and largest heartbeat gap, the card's
    ``memory.used`` rise, kill to
    ``revoke`` and ``revoke`` to the moved user's re-admission, users/s
    against phase 19 (c); (b) the same run killed by
    ``CETPU_FAULTS=fabric.assign:kill@FABRIC_USERS+1`` (the failover's
    assign) and run again: no worker of the killed run outlives the
    restart, the finished users are skipped, every user ends once on
    (a)'s songs; (c), on a thread beside (b), FABRIC_C_USERS users with
    the host registry from 1 host to 2 (one ``spawn`` under the backlog)
    and back (one ``drain``, an in-flight user's ``fence`` acked with its
    generation, its ``assign`` elsewhere, ``drain_done``), every user's
    metrics and state equal its sequential run's.  ``linear_mc``
    launches are counted in every process (0);
21. operator: the operator plane over phase 20's runs (the plane is on by
    default).  (a) a thread reads (a)'s ``users/status/`` every
    STATUS_POLL_S s: live snapshots of the coordinator, h0 and h1, each
    clean under ``validate_status``, all three in one ``top`` frame, h1
    STALE within STATUS_STALE_S s of its SIGKILL, ``top --once`` on the
    directory; snapshots per host and the largest gap between them; (b)
    (c) runs with ``--alert-sink jsonl:<path>``: every record parses, no
    snapshot counts a sink failure; (c) ``fsck`` exits 0 over (a)'s and
    (c)'s users directories (files by class, wall time), 1 on a copy with
    a byte flipped in the journal's middle line and in a member ``.npz``
    (both named), and after ``--repair`` the line is quarantined, the
    member still reported and the journal valid; (d) ``report --validate
    --out`` over (a)'s directory, ``soak gen`` with phase 19 (a)'s trace
    parameters to its digest (``digest`` too), ``soak grade`` on phase 19
    (a)'s run to ``grade_run``'s deterministic section;
22. generic: phase 11's registry plus one frozen generic member of each
    kind at F = 260, every one fitted by the port without scikit-learn on
    phase 12's DEAM-scale rows (knn by ``train.pretrain``, one fold; rf on
    the first GENERIC_RF_ROWS rows; gbc, svc and gpc on the first
    GENERIC_CUT_ROWS), and the boosted slot's scikit-learn member on the
    first GENERIC_CUT_ROWS with two updates; each fit held to
    scikit-learn 1.9.0's fingerprint of the same rows (GENERIC_SIZES,
    ``python -m tests.torch_generic_sizes``) and timed on the host clock;
    ``amg_test`` GENERIC_ARGS on the card and on the CPU (run inside
    phase 11): the queried songs equal every epoch, each generic member's
    probabilities unchanged by every update, the workspaces' generic
    members the registry's; each kind's host-clock ms of
    ``predict_proba`` and ``predict`` at the pool's size.

A line before the JSON lines gives each group of phases' wall time.

Every check raises, so any failure exits non-zero and prints no result.
The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits non-zero.
"""

import contextlib
import copy
import csv
import dataclasses
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import signal
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from consensus_entropy_tpu_torch import acquire, native, prng  # noqa: E402
from consensus_entropy_tpu_torch.al.acquisition import Acquirer  # noqa: E402
from consensus_entropy_tpu_torch.al.linear_pool import LinearPoolScorer  # noqa: E402
from consensus_entropy_tpu_torch.al import state as al_state  # noqa: E402
from consensus_entropy_tpu_torch.al.loop import ALLoop, UserData  # noqa: E402
from consensus_entropy_tpu_torch.cli import amg_test  # noqa: E402
from consensus_entropy_tpu_torch.cli import fsck as fsck_cli  # noqa: E402
from consensus_entropy_tpu_torch.cli import report as report_cli  # noqa: E402
from consensus_entropy_tpu_torch.cli import soak as soak_cli  # noqa: E402
from consensus_entropy_tpu_torch.cli import top as top_cli  # noqa: E402
from consensus_entropy_tpu_torch.config import (  # noqa: E402
    FEATURE_SLICE_START,
    FEATURE_SLICE_STOP,
    ALConfig,
    CNNConfig,
    PathsConfig,
    TrainConfig,
)
from consensus_entropy_tpu_torch.convert import (  # noqa: E402
    device_members_from_numpy,
    linear_members_from_jax,
)
from consensus_entropy_tpu_torch.data import amg  # noqa: E402
from consensus_entropy_tpu_torch.data.audio import (  # noqa: E402
    DeviceWaveformStore,
)
from consensus_entropy_tpu_torch.kernels import build, linear_mc  # noqa: E402
from consensus_entropy_tpu_torch.labels import one_hot_np  # noqa: E402
from consensus_entropy_tpu_torch.models import short_cnn  # noqa: E402
from consensus_entropy_tpu_torch.models.cnn_trainer import (  # noqa: E402
    CNNTrainer,
    bce_loss,
)
from consensus_entropy_tpu_torch.models.committee import (  # noqa: E402
    CNNMember,
    Committee,
    DeviceMemberCommittee,
    FramePool,
)
from consensus_entropy_tpu_torch.models.gbdt import (  # noqa: E402
    GBDT,
    NativeGBDTMember,
    QuantileBinner,
)
from consensus_entropy_tpu_torch.models.generic_members import (  # noqa: E402
    GENERIC_KINDS,
    GenericMember,
)
from consensus_entropy_tpu_torch.models.members import (  # noqa: E402
    GNBMember,
    SGDMember,
    make_boosted_member,
)
from consensus_entropy_tpu_torch.fleet import (  # noqa: E402
    FleetReport,
    FleetScheduler,
    FleetUser,
)
from consensus_entropy_tpu_torch.obs.export import (  # noqa: E402
    chrome_trace,
    find_span_files,
    load_spans,
    orphan_spans,
    read_jsonl_tolerant,
    validate_metrics_file,
)
from consensus_entropy_tpu_torch.obs.metrics import StepTimer  # noqa: E402
from consensus_entropy_tpu_torch.obs.status import (  # noqa: E402
    read_status_dir,
    validate_status,
)
from consensus_entropy_tpu_torch.obs.trace import Tracer  # noqa: E402
from consensus_entropy_tpu_torch.parallel import (  # noqa: E402
    multihost,
    pool_mesh,
    sharding,
)
from consensus_entropy_tpu_torch.parallel.mesh import (  # noqa: E402
    ShardedRows,
    make_pool_mesh,
    make_seq_mesh,
)
from consensus_entropy_tpu_torch.parallel.sequence import (  # noqa: E402
    full_song_probs_reference,
    plan_windows,
)
from consensus_entropy_tpu_torch.ops import scoring  # noqa: E402
from consensus_entropy_tpu_torch.al import workspace  # noqa: E402
from consensus_entropy_tpu_torch.serve import (  # noqa: E402
    AdmissionJournal,
    FleetServer,
    ServeConfig,
)
from consensus_entropy_tpu_torch.workload import (  # noqa: E402
    ServerTarget,
    TraceDriver,
    TraceSpec,
    generate,
    grade_run,
    percentile,
    trace_digest,
)
from consensus_entropy_tpu_torch.train import pretrain  # noqa: E402
from consensus_entropy_tpu_torch.ops.entropy import (  # noqa: E402
    shannon_entropy,
)
from consensus_entropy_tpu_torch.ops.mel import (  # noqa: E402
    log_mel_spectrogram,
)
from consensus_entropy_tpu_torch.ops.scoring import make_scoring_fns  # noqa: E402
from consensus_entropy_tpu_torch.ops.topk import (  # noqa: E402
    masked_top_k,
    reveal_mask_update,
    valid_count,
)

# The repo's entropy gate (tests/test_pallas_scoring.py): float32 sums taken
# in another order by the kernel than by the plain version's cuBLAS GEMM.
RTOL, ATOL = 1e-5, 1e-6
# At bench widths (F=260, M=16, C=4, K=4) the gate alone would pass a
# kernel that ran one TF32 product instead of three (7.5e-6 on 2,000 songs,
# tests/test_torch_tf32_split.py).  Three products stay near float32's
# 2.4e-7, so the largest entropy error there must stay under this.
SPLIT_MAX_ERR = 1e-6
# BASELINE.json configs[4] / bench.py's defaults for the linear committee.
M, N, K, F, C, Q, ITERS, SEED = 16, 100_000, 4, 260, 4, 10, 10, 1987
MASKED_SHARE = 0.03
# H100 SXM data sheet at 700 W: HBM rate, float32 rate off the tensor
# cores, and the dense TF32 tensor-core rate the kernel's 3xTF32 runs at.
PEAK_BYTES_S, PEAK_F32_FLOP_S, PEAK_TF32_FLOP_S = 3.35e12, 67e12, 495e12
REPS = 50
# The slice step moves more between runs than the kernel: more repetitions.
STEP_REPS = 400
# The step's parts (merge, mask update) are too short for events around each
# call: LOOP_CALLS back-to-back calls between one pair, median of LOOP_ROUNDS.
LOOP_CALLS, LOOP_ROUNDS = 200, 25
# The acquisition slice on the same pool: 8 GaussianNB and 8 SGD-logistic
# members, the hc table's seed (bench.py::make_hc_table), qbdc's K forwards.
G_MEMBERS, S_MEMBERS, HC_SEED, QBDC_K = 8, 8, 2021, ALConfig().qbdc_k
# tests/test_device_members.py:31,40: GNB's float32 expanded Mahalanobis
# form cancels (ROADMAP C5), SGD-OvA does not.
GNB_TOL, SGD_TOL = {"rtol": 1e-3, "atol": 1e-5}, {"rtol": 1e-4, "atol": 1e-6}
SELECT_REPS, SELECT_ROUNDS, SELECT_WARMUP, PROFILED_SELECTS = 50, 5, 5, 10
# The AL loop (phase 10): BASELINE.json configs[4]'s iteration, the modes
# the host-member committee runs, AL_EPOCHS iterations each (cut from 10:
# at 10, and 4 iterations in phase 14, the script took 684.5 s on one
# card machine's host and 1034.3 s on a slower one, too near its 1200 s
# limit; then from 5 to 3 to pay for phase 15, and to 2 for phase 20).
AL_EPOCHS, TRAIN_SIZE, AL_MODES = 2, 0.85, ("mc", "hc", "mix", "rand", "wmc")
# Labelled rows each member is fitted on (its own seeded draw), the class
# centres' spread, and the iteration traced for the busy share.
GNB_FIT_ROWS, SGD_FIT_ROWS, CENTER_SD, PROFILED_EPOCH = 4000, 128, 0.1, 1
TIMED_PHASES = ("score", "select", "update_host", "evaluate", "checkpoint",
                "ckpt_join")
# The CLI (phase 11) at AMG1608's shape: songs, frames per song, annotators
# and each one's chance to annotate a song, registry members of each kind.
AMG_SONGS, AMG_FRAMES, AMG_USERS, ANNOTATE_P, REG_MEMBERS = (
    1608, (4, 9), 6, 0.3, 5)
CLI_EPOCHS = 10
CLI_ARGS = ["-q", "10", "-e", str(CLI_EPOCHS), "-m", "mc", "-n", "150",
            "--max-users", "2"]
# Phase 11's CNN registry: 4-s clips in npy/ (AMG1608's are 30 s), two
# GBDT and two vgg members at a narrow width, so the CPU run keeps up; two
# iterations of two retrain epochs, one user; the CPU's reference run stops
# after the iteration it is compared on (CLI_CNN_CPU_EPOCHS), for the time
# limit.
CLI_CLIP_SAMPLES, CLI_XGB, CLI_CNN_MEMBERS, CLI_CNN_EPOCHS = 4 * 16000, 2, 2, 2
CLI_CNN_CPU_EPOCHS = 1
CLI_CNN = {"n_channels": 8, "input_length": 32768}
CLI_CNN_ARGS = ["-q", "10", "-e", str(CLI_CNN_EPOCHS), "-n", "150",
                "--max-users", "1", "--retrain-epochs", "2"]
# ... and once more with res members scoring whole songs on a grid of
# 16,384-sample hops (2 windows of a 4-s clip)
CLI_FULL_SONG = {"arch": "res", "hop": 16384}
# Phase 12: the GBDT core at DEAM pre-training scale (1802 songs x 60
# frames, 2 Hz over the annotated 15-45 s), 256 bins, depth 5; the rows an
# AL member's fit sees (phases 12 and 14) and the rounds of the forest
# whose margins are checked.
DEAM_SONGS, DEAM_FRAMES, GBDT_BINS, GBDT_DEPTH = 1802, 60, 256, 5
GBDT_FIT_ROWS, GBDT_CHECK_ROUNDS = 1000, 2
# Phase 13: the vgg CNN at full width: members, crops (one crop bucket),
# members and crops held against the CPU, passes timed; 30-s clips.
CNN_MEMBERS, CNN_CROPS, CNN_CHECK_MEMBERS, CNN_CHECK_CROPS, CNN_REPS = (
    5, 256, 2, 16, 5)
CLIP_SAMPLES = 30 * 16000
# Card against CPU: sigmoid scores (float32 convolutions summed in another
# order by cuDNN than by the CPU's), the log-mel frontend against float64
# (dB), losses over FIT_EPOCHS epochs of training.  Training is chaotic in
# float32: Adam turns a gradient coordinate near zero into a step of about
# lr whatever its size, so rounding noise in such coordinates moves weights
# by lr a step on one device and not the other, and the losses part by a
# few percent within three epochs while the draws stay equal.  The tight
# check of the training path is GRAD64_REL_TOL below; FIT_TOL only holds
# the trajectories together.
CNN_TOL = {"rtol": 1e-4, "atol": 1e-5}
MEL_TOL = {"rtol": 1e-5, "atol": 1e-3}
FIT_TOL = {"rtol": 5e-2, "atol": 1e-3}
# One training step's gradient at the same weights, crops and dropout
# mask, card against CPU (relative L2).  In float64 the two agree to
# rounding: this holds the backward graph on the card.  In float32 a near
# tie in a 2x2 max pool can send a channel's gradient down another path on
# either side, so float32 gradients can part by a few percent from each
# other and from float64 at some inputs; the float32 bound only holds them
# together, and the float32 forward is held tightly by CNN_TOL.
GRAD64_REL_TOL, GRAD32_REL_TOL = 1e-6, 5e-2
# fit_many in phase 13: a retrain's shape (q songs, the test split of a
# USER_SONGS-song user), FIT_EPOCHS epochs.
FIT_SONGS, FIT_TEST_SONGS, FIT_EPOCHS = 10, 60, 3
# Phase 14: AMG1608's 1608 songs of 30 s in the store, one user with 400
# annotated songs of USER_FRAMES frames, 5 members of each kind, the
# CNNs' short fit before the run, q=10 for FULL_EPOCHS[mode] iterations
# (cut from the paper's 10 to keep the script inside its time limit, and
# from 4 and 3 to pay for phase 15, then to 2 and 1 for phase 17, and to
# 1 and 1 for phase 20; widths are not cut) of FULL_RETRAIN_EPOCHS retrain
# epochs (the paper's 100, then 50, until phase 22 needed the time),
# FULL_PROFILED_MODE's iteration FULL_PROFILED_EPOCH traced (its medians
# then stand on that traced iteration, mc's on an untraced one); the
# narrow CNN of the card-vs-CPU run, one iteration with its retrain
# epochs cut (iteration 0's selection, which it checks, comes before any
# retrain).
FULL_SONGS, USER_SONGS, USER_FRAMES, FULL_MEMBERS = 1608, 400, 6, 5
FULL_EPOCHS, FULL_RETRAIN_EPOCHS = {"mc": 1, "qbdc": 1}, 25
FULL_PROFILED_MODE, FULL_PROFILED_EPOCH = "qbdc", 0
PRE_FIT_SONGS, PRE_FIT_EPOCHS = 20, 2
NARROW_CNN, NARROW_EPOCHS = {"n_channels": 16, "input_length": 32768}, 1
NARROW_RETRAIN_EPOCHS = 1  # 2 until phase 20 needed the time
FULL_PHASES = ("score", "select", "update_host", "retrain_cnn", "evaluate",
               "checkpoint", "ckpt_join")
# Phase 15: the four other trunk families at full width (CNNConfig(arch=a)),
# each as phase 13 holds vgg: CNN_MEMBERS members over one CNN_CROPS-crop
# bucket of 30-s clips, timed over TRUNK_REPS passes; CNN_CHECK_MEMBERS x
# CNN_CHECK_CROPS crops (inference; features and qbdc of the first) and one
# float64 training step against the CPU port; a TRUNK_FIT_EPOCHS-epoch
# fit_many of CNN_CHECK_MEMBERS members on FIT_SONGS songs (validated on
# FIT_TEST_SONGS), the first held against the CPU.  Features are ReLU
# outputs of any size: rtol 1e-4 / atol 1e-4, as the CPU tests hold them.
TRUNK_ARCHS, TRUNK_REPS, TRUNK_FIT_EPOCHS = (
    ("res", "harm", "se1d", "musicnn"), 2, 1)
FEAT_TOL = {"rtol": 1e-4, "atol": 1e-4}
# Full-song scoring: SONGS seeded clips of SONG_SECONDS s at 16 kHz, mixed
# lengths so the validity masks bite (up to 15 windows of a half-crop hop),
# CNN_MEMBERS harm members; SONG_CHECK songs x CNN_CHECK_MEMBERS members
# against the CPU.
SONGS, SONG_SECONDS, SONG_HOP, SONG_CHECK = 64, (15, 30), 29524, 8
# The harm AL run: phase 14's user with 5 GaussianNB + 5 SGD and
# HARM_MEMBERS full-width harm members scoring full songs at HARM_HOP;
# HARM_EPOCHS iterations of HARM_RETRAIN retrain epochs, mc (cut from 2
# iterations to pay for phase 20).
HARM_MEMBERS, HARM_HOP, HARM_EPOCHS, HARM_RETRAIN = 2, 59049, 1, 10
# Phase 16, the fleet engine.  (a) FLEET_USERS users' configs[4]-scale
# tables through the fleet scorers, timed over FLEET_REPS; (b) a cohort of
# HOST_COHORT AMG1608 users with REG_MEMBERS GaussianNB + REG_MEMBERS SGD,
# mc for FLEET_EPOCHS iterations, FLEET_HOST_WORKERS host workers, fleet
# and sequential alternated FLEET_ROUNDS times (host-clock phases swing
# between calls); (c) FULL_COHORT users with phase 14's committee kinds,
# FULL_FLEET_EPOCHS iterations of FLEET_RETRAIN retrain epochs (cut from
# 100, and from 4 users and 2 mc iterations after the whole script's
# phase 16 took 251.1 s on a card machine, for the time limit; then from
# 3 users of 5 retrain epochs to 2 of 1, and (b) from 2 rounds to 1, to
# pay for phase 20; widths are not cut; (b) from 3 iterations to 2 for
# phase 22); (d) the CLI's --fleet 2 for FLEET_CLI_EPOCHS
# iterations (a prefix of phase 11's sequential run).
FLEET_USERS, FLEET_REPS = 4, 20
HOST_COHORT, FLEET_EPOCHS, FLEET_HOST_WORKERS, FLEET_ROUNDS = 8, 2, 4, 1
FULL_COHORT, FULL_FLEET_EPOCHS, FLEET_RETRAIN = 2, {"mc": 1, "qbdc": 1}, 1
FLEET_FIT_USERS, FLEET_FIT_MEMBERS, FLEET_FIT_EPOCHS = 2, 2, 2
FLEET_CLI_EPOCHS = 3
# Phase 17: DEAM pre-training at the dataset's scale (DEAM_SONGS songs of
# DEAM_FRAMES frames, DEAM_CLIP_S-s clips at 16 kHz on the card): PRE_CV
# folds of gnb and sgd, one PRE_XGB_ROUNDS-round xgb fold, one vgg fold of
# PRE_CNN_EPOCHS epochs at full width; the registry through amg_test
# (PIPELINE_ARGS) on phase 11's tree; the evidence sweep (GaussianNB
# committees; mc, hc, mix, rand) on the card and the CPU.  Phases 17 and
# 22 run beside phase 11, each in a process of its own (``--beside``).
DEAM_CLIP_S, PRE_CV, PRE_CNN_EPOCHS = 45, 2, 1  # 5 and 2 before phase 20
PRE_XGB_ROUNDS = 25
# the SGD core against its Python plain version in (b): one one-vs-all
# problem over every DEAM frame, with the fit's stopping rule tracked
SGD_CHECK_EPOCHS = 2
PIPELINE_ARGS = ["-q", "10", "-n", "150", "--max-users", "1", "-e", "1",
                 "-m", "mc", "--retrain-epochs", "2"]
EVIDENCE_ARGS = ["sweep", "--seeds", "2", "--epochs", "4"]
# Phase 18: the pool-axis mesh on one card.  (a) B2 over MESH_B2_SHARDS
# shards of phase 3's pool (25,000 rows a shard); (b) the six fused modes
# over MESH_STEP_SHARDS shards, MESH_ITERS selects each; (c) one seeded
# SEQ_SONG_S-s song (9.6 M samples, 162 windows of 59,049 at hop =
# window) scored by SEQ_MEMBERS full-width harm members over SEQ_SHARDS
# shards, timed over SEQ_REPS calls.
MESH_B2_SHARDS, MESH_STEP_SHARDS, MESH_ITERS = 4, 2, ITERS
SEQ_SONG_S, SEQ_MEMBERS, SEQ_SHARDS, SEQ_REPS = 600, 2, 4, 5
SEQ_HALO_SONG_S = 60
# Phase 19: single-host serving.  (a) a SERVE_USERS-user trace (seed
# SERVE_TRACE_SEED: two classes, pools skewed over SERVE_POOLS, Poisson
# arrivals compressed into SERVE_TRACE_S s) through a SERVE_LIVE-slot
# FleetServer, phase 16 (b)'s committee, mc, SERVE_EPOCHS iterations; (b)
# the same trace killed at the SERVE_KILL_AT-th journal append and
# restarted (mid-run whatever the timing: 8 enqueues, one planner epoch
# and 4 admits need no finish and each further admit needs one, so 19
# appends hold at least 3 finishes, and all 8 take 25 appends);
# (c) the CLI's --serve 2 on phase 11's tree, two users, its first
# SERVE_PROFILE_N dispatches profiled.
SERVE_USERS, SERVE_LIVE, SERVE_EPOCHS, SERVE_TRACE_S = 8, 4, 3, 2.0
SERVE_TRACE_SEED, SERVE_POOLS, SERVE_KILL_AT = 7, (150, 400), 20
SERVE_CLI_ARGS = ["-q", "10", "-e", str(CLI_CNN_EPOCHS), "-n", "150",
                  "--max-users", "2", "--retrain-epochs", "2"]
SERVE_CLI_WIDTHS, SERVE_PROFILE_N = "512,1024", 10
# Phase 20: the multi-host fabric, ``amg_test --serve 1 --hosts 2`` as a
# subprocess.  (a) and (b): FABRIC_USERS users of phase 11's tree with its
# GBDT + vgg registry (phase 19 (c)'s flags at 1 iteration, for the time
# limit), placed least-loaded so each worker holds two; (c): FABRIC_C_USERS users (phase 11's songs, their own
# annotators) with its host registry, FABRIC_C_ARGS, from 1 host up to 2
# (the backlog of 10 queued users passes 8 a host) and down again after
# FABRIC_SCALE_DOWN_S s of low water.  A run may take FABRIC_TIMEOUT_S s.
FABRIC_DEVICE, FABRIC_USERS, FABRIC_TIMEOUT_S = "cuda", 4, 300
FABRIC_ARGS = ["-q", "10", "-e", "1", "-n", "150", "--max-users",
               str(FABRIC_USERS), "--retrain-epochs", "2"]
FABRIC_C_USERS, FABRIC_SCALE_DOWN_S = 10, 0.5
FABRIC_C_ARGS = ["-q", "10", "-e", "4", "-n", "150", "--max-users",
                 str(FABRIC_C_USERS)]
# Phase 21: the operator plane over runs of phases 19 and 20.  (a) a thread
# reads phase 20 (a)'s status directory every STATUS_POLL_S s and renders
# top's frame with --stale-s STATUS_STALE_S (a snapshot is stale after 3 of
# its writer's 1 s intervals, so the killed h1's shows STALE within it).
STATUS_POLL_S, STATUS_STALE_S = 0.5, 5.0
# (b) phase 20 (c) runs with --alert-sink jsonl:<path> and a batch aging
# bound of FABRIC_C_AGING_S s, which its queued users pass (every user is
# batch, so aging reorders none): each worker raises batch_aging alerts
FABRIC_C_AGING_S = 1.0
# Phase 22: the generic members at full width (F = 260, C = 4).  The
# committee is phase 11's REG_MEMBERS GaussianNB + REG_MEMBERS SGD registry
# plus one member of each generic kind, each fitted by the port on phase
# 12's DEAM-scale rows: knn by the port's pretrain (one fold of 80% of the
# songs); rf on the first GENERIC_RF_ROWS rows; gbc, svc and gpc on the
# first GENERIC_CUT_ROWS.  The boosted slot's scikit-learn member fits the
# first GENERIC_CUT_ROWS and takes two updates (generic_update_batches).
# The row counts are cut from the 108,120 rows for time: scikit-learn's
# gbc alone on the 20,000 rows that gbc was once sized at took 670 s on
# an 8-core CPU, more than the whole script's budget, and gpc is cubic in
# its rows.  amg_test GENERIC_ARGS on phase 11's tree, card and CPU.
GENERIC_ARGS = ["-q", "10", "-e", "2", "-n", "150", "--max-users", "2",
                "-m", "mc"]
GENERIC_RF_ROWS, GENERIC_CUT_ROWS, GENERIC_SAMPLE_ROWS = 20000, 2000, 64
# scikit-learn 1.9.0's fingerprints (generic_fingerprint) of phase 22's
# fits on the same rows: ``python -m tests.torch_generic_sizes``, whose
# output this is (the per-fit seconds left out).  gpc on these rows is
# degenerate: RBF(1.0) over 260 standard-normal features is nearly the
# identity, its constants stay at their lower bound and every class
# probability near 0.25.
GENERIC_SIZES = json.loads("""
{"gbc": {"leaf_abs": 781.8328217224476, "leaf_sum": [7.441687183088401,
6.745628473424229, 7.529535014379903, 7.375282160354793, 6.074177633458552,
6.005734160685288, 3.4192278762241664, 4.698056806268709, 3.478618342569157,
3.7962431828279155, 2.7995617979448757, 2.704727500230468,
3.730169815605172, 4.179528461454455, 3.584839117715818, 2.4342888590670935,
2.6785088099276706, 2.369920519629874, 2.2833728424705497,
1.6914142246897708, 2.0347042884921, 1.5298502095558986, 2.6619896674722208,
0.9433268991331952, 1.4600477010469413, 3.166274239314201,
2.503162206699891, 0.284389762466673, 2.6430137952745474,
1.7992265108820744, 1.63242477896229, 1.7991939971253506, 2.236199474948488,
1.8619513125975864, 1.815876929730503, 1.271232635373166,
2.4166168056425597, 1.390076135734124, 2.402138625314357, 1.73441694852956,
2.128603159658472, 0.8023964134203508, 2.5404425090698375,
2.245507364299729, 1.2750868575878012, 3.100529078406839, 1.532132208777371,
1.5081202138565852, 1.6235925288899946, 2.089562648395083,
1.9406346111952084, 2.273717457783084, 2.472857799570345, 2.207592824091193,
2.1522249105441933, 2.4753936603453233, 1.9663448886045036,
1.7251891633452883, 1.7097949264781218, 1.9758160936058218,
3.787322447881414, 2.670788828781359, 1.071868790198088, 2.236426329752902,
1.2503357775872135, 2.2388081888193585, 1.2192583413070452,
4.431152343504633, 1.5470822796338422, 1.6777018698454502,
2.7404061596565716, 1.4755894032538728, 1.6628541065315663,
2.7996500087455143, 0.5137431256531513, 1.177323051632677,
1.532355185471293, 2.401760214729724, 2.767454306548338, 1.76456619808621,
2.0137632010033, 1.8316499253346457, 2.452923295735399, 1.9012809231441794,
1.6988082640113409, 2.942539667520492, 1.741651360176665,
2.6816162827405954, 1.623338560685955, 1.2182735823934516,
1.4759859572188794, 1.5026375327112154, 2.152196659318341,
1.8669376323502869, 3.059188312685994, 0.8430567552168919,
2.8472947955330206, 1.182035999869342, 1.1525977156436167,
1.7082524058665158], "nodes": [7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
7, 7, 7, 7, 7, 7, 7, 7, 7, 7], "predict": [0, 1, 3, 0, 3, 2, 1, 3, 2, 2, 1,
0, 0, 2, 1, 3, 3, 3, 2, 2, 2, 0, 1, 3, 2, 0, 1, 0, 0, 1, 1, 2, 0, 2, 1, 2,
0, 0, 2, 2, 3, 2, 3, 2, 0, 1, 2, 3, 3, 2, 2, 3, 3, 3, 1, 3, 1, 3, 0, 1, 3,
2, 1, 3], "proba_sum": [12.979486705058752, 14.096330892913429,
18.923427669542207, 18.00075473248562]}, "gpc": {"constant":
[9.999999999999997e-06, 9.999999999999997e-06, 9.999999999999997e-06,
9.999999999999997e-06], "length_scale": [1.0, 1.0, 1.0, 1.0], "predict": [0,
0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], "proba_sum": [16.0, 16.0, 16.0,
16.0]}, "rf": {"depth": [27, 30, 26, 29, 24, 28, 29, 24, 25, 30, 23, 26, 27,
27, 29, 29, 32, 24, 26, 27, 24, 29, 28, 27, 28, 28, 25, 29, 24, 32, 22, 24,
25, 25, 23, 24, 29, 26, 23, 28, 27, 25, 30, 25, 29, 32, 26, 24, 24, 30, 23,
23, 28, 26, 28, 25, 27, 23, 31, 24, 25, 30, 24, 24, 33, 31, 24, 31, 30, 22,
31, 31, 27, 26, 29, 26, 21, 25, 24, 27, 24, 24, 26, 25, 28, 27, 34, 27, 25,
24, 28, 26, 37, 25, 28, 29, 23, 29, 25, 26], "nodes": [2607, 2173, 2363,
2455, 2355, 2353, 2451, 2487, 2441, 2261, 2297, 2227, 2607, 2357, 2355,
2357, 2107, 2403, 2341, 2409, 2407, 1927, 2495, 2485, 2343, 2491, 2405,
2723, 2393, 2281, 2541, 2473, 2605, 2373, 2309, 2463, 2441, 2473, 2229,
2349, 2261, 2573, 2295, 2449, 2289, 2623, 2389, 2469, 2523, 2323, 2395,
2439, 2143, 2561, 2281, 2315, 2551, 2183, 2473, 2593, 2259, 2359, 2475,
2165, 2331, 2599, 2431, 2491, 2507, 2451, 2433, 2513, 2565, 2381, 2399,
2441, 2447, 2325, 2349, 2673, 2483, 2595, 2407, 2527, 2501, 2399, 2417,
2389, 2457, 2427, 2231, 2543, 2397, 2281, 2329, 2643, 2657, 2531, 2349,
2369], "predict": [0, 1, 3, 0, 3, 2, 1, 3, 2, 2, 1, 0, 0, 2, 1, 3, 3, 3, 2,
2, 2, 0, 1, 3, 2, 0, 1, 0, 0, 1, 1, 2, 0, 2, 1, 2, 0, 0, 2, 2, 3, 2, 3, 2,
0, 1, 2, 3, 3, 2, 2, 3, 3, 3, 1, 3, 1, 3, 0, 1, 3, 2, 1, 3], "proba_sum":
[13.349999999999998, 14.149999999999995, 18.22999999999999,
18.270000000000003]}, "svc": {"gamma": 0.00308341044745519, "n_support":
[244, 230, 267, 241], "predict": [0, 1, 3, 0, 3, 2, 1, 3, 2, 2, 1, 0, 0, 2,
1, 3, 3, 3, 2, 2, 2, 0, 1, 3, 2, 0, 1, 0, 0, 1, 1, 2, 0, 2, 1, 2, 0, 0, 2,
2, 3, 2, 3, 2, 0, 1, 2, 3, 3, 2, 2, 3, 3, 3, 1, 3, 1, 3, 0, 1, 3, 2, 1, 3],
"prob_a": [-6.154111882547254, -6.1950351494751645, -6.145894949625295,
-6.1008568607709615, -6.104619146395228, -6.1586379756108585], "prob_b":
[0.020345677764727264, -0.0028391717078976014, -0.0032707096967393174,
-0.002426405754358345, -0.007208612987997491, -0.007158267890744414],
"proba_sum": [13.01293071537542, 14.00563813680621, 18.971963276870575,
18.009467870947795]}, "xgb": [{"leaf_abs": 5106.535658478511, "leaf_sum":
[127.14492192254477, 88.0967995823901, 74.80948866187643, 39.97951092473685,
56.474254685331886, 43.980569251964646, 37.7737695499769, 35.65929391798582,
27.135217869478836, 37.09788337603027, 19.779710319353367,
19.54372752189835, 13.053396805503834, 25.388641820286416,
14.39876500208645, 19.744726798699855, 36.16125203295685,
13.065565036180562, 31.65522880259975, 12.467075924043504,
14.569212696197317, 19.898053549465228, 26.083041650032033,
23.78962321440067, 13.613781002882185, 23.480344105179555,
10.332821548849548, 15.260340870726324, 18.8964057793084, 13.50750383341732,
22.168444574092227, 17.813660761381108, 15.210725842732755,
16.813001152491406, 21.838958557460664, 23.526322557245997,
25.268501988441894, 20.44180021965354, 12.100801474744053,
24.39171515580616, 15.482800751014082, 19.733959990150293,
21.042629708156745, 18.855322787238507, 16.872661122060315,
19.407220759979527, 16.574887988519695, 20.42741769851277,
17.106728170731778, 26.678910188033793], "nodes": [55, 59, 61, 57, 59, 63,
63, 61, 59, 63, 63, 63, 59, 63, 63, 63, 57, 63, 63, 63, 63, 61, 63, 63, 63,
63, 63, 61, 61, 63, 63, 63, 63, 63, 63, 63, 61, 63, 63, 63, 61, 63, 63, 63,
59, 63, 63, 63, 63, 63, 63, 63, 59, 63, 63, 63, 59, 61, 63, 63, 63, 63, 63,
63, 59, 63, 61, 63, 61, 61, 61, 63, 61, 61, 63, 63, 63, 63, 63, 63, 57, 61,
63, 61, 61, 63, 61, 63, 59, 63, 55, 63, 63, 61, 63, 63, 57, 63, 63, 61, 57,
61, 63, 59, 61, 63, 61, 63, 59, 61, 49, 61, 57, 63, 63, 61, 55, 63, 63, 61,
61, 63, 55, 63, 51, 63, 57, 57, 59, 61, 59, 63, 61, 63, 61, 61, 61, 61, 63,
59, 61, 61, 59, 61, 55, 61, 61, 63, 55, 63, 63, 63, 59, 61, 57, 59, 61, 63,
63, 61, 63, 61, 63, 61, 57, 59, 59, 61, 59, 63, 63, 61, 63, 63, 63, 61, 63,
63, 63, 63, 55, 63, 57, 61, 63, 63, 59, 63, 63, 63, 61, 63, 63, 63, 63, 59,
53, 63, 63, 57], "predict": [0, 1, 3, 0, 3, 2, 1, 3, 2, 2, 1, 0, 0, 2, 1, 3,
3, 3, 2, 2, 2, 0, 1, 3, 2, 0, 1, 0, 0, 1, 1, 2, 0, 2, 1, 2, 0, 0, 2, 2, 3,
2, 3, 2, 0, 1, 2, 3, 3, 2, 2, 3, 3, 3, 1, 3, 1, 3, 0, 1, 3, 2, 1, 3],
"proba_sum": [13.29004345739502, 13.661162397634065, 18.6295541172727,
18.41924002769822]}, {"leaf_abs": 5393.757238821012, "leaf_sum":
[127.14492192254477, 88.0967995823901, 74.80948866187643, 39.97951092473685,
56.474254685331886, 43.980569251964646, 37.7737695499769, 35.65929391798582,
27.135217869478836, 37.09788337603027, 19.779710319353367,
19.54372752189835, 13.053396805503834, 25.388641820286416,
14.39876500208645, 19.744726798699855, 36.16125203295685,
13.065565036180562, 31.65522880259975, 12.467075924043504,
14.569212696197317, 19.898053549465228, 26.083041650032033,
23.78962321440067, 13.613781002882185, 23.480344105179555,
10.332821548849548, 15.260340870726324, 18.8964057793084, 13.50750383341732,
22.168444574092227, 17.813660761381108, 15.210725842732755,
16.813001152491406, 21.838958557460664, 23.526322557245997,
25.268501988441894, 20.44180021965354, 12.100801474744053,
24.39171515580616, 15.482800751014082, 19.733959990150293,
21.042629708156745, 18.855322787238507, 16.872661122060315,
19.407220759979527, 16.574887988519695, 20.42741769851277,
17.106728170731778, 26.678910188033793, -11.975862463769783,
-11.981942596620852, -11.986395119875015, -11.98967891943462,
-11.992116912072362, -11.993938483256082, -11.995307917015868,
-11.996343724175862, -11.997131949553534, -11.997735433910897], "nodes":
[55, 59, 61, 57, 59, 63, 63, 61, 59, 63, 63, 63, 59, 63, 63, 63, 57, 63, 63,
63, 63, 61, 63, 63, 63, 63, 63, 61, 61, 63, 63, 63, 63, 63, 63, 63, 61, 63,
63, 63, 61, 63, 63, 63, 59, 63, 63, 63, 63, 63, 63, 63, 59, 63, 63, 63, 59,
61, 63, 63, 63, 63, 63, 63, 59, 63, 61, 63, 61, 61, 61, 63, 61, 61, 63, 63,
63, 63, 63, 63, 57, 61, 63, 61, 61, 63, 61, 63, 59, 63, 55, 63, 63, 61, 63,
63, 57, 63, 63, 61, 57, 61, 63, 59, 61, 63, 61, 63, 59, 61, 49, 61, 57, 63,
63, 61, 55, 63, 63, 61, 61, 63, 55, 63, 51, 63, 57, 57, 59, 61, 59, 63, 61,
63, 61, 61, 61, 61, 63, 59, 61, 61, 59, 61, 55, 61, 61, 63, 55, 63, 63, 63,
59, 61, 57, 59, 61, 63, 63, 61, 63, 61, 63, 61, 57, 59, 59, 61, 59, 63, 63,
61, 63, 63, 63, 61, 63, 63, 63, 63, 55, 63, 57, 61, 63, 63, 59, 63, 63, 63,
61, 63, 63, 63, 63, 59, 53, 63, 63, 57, 15, 21, 19, 17, 15, 21, 19, 17, 15,
21, 19, 17, 15, 21, 19, 17, 15, 21, 19, 17, 15, 21, 19, 17, 15, 21, 19, 17,
15, 21, 19, 17, 15, 21, 19, 17, 15, 21, 19, 17], "predict": [0, 1, 3, 0, 3,
2, 1, 3, 2, 2, 1, 0, 0, 2, 1, 3, 3, 3, 2, 2, 2, 0, 1, 3, 2, 0, 1, 0, 0, 1,
1, 2, 0, 2, 1, 2, 0, 0, 2, 2, 3, 2, 3, 2, 0, 1, 2, 3, 3, 2, 2, 3, 3, 3, 1,
3, 1, 3, 0, 1, 3, 2, 1, 3], "proba_sum": [13.009020349082077,
14.174113317527553, 18.474063970518475, 18.342802362871904]}, {"leaf_abs":
5676.575127590172, "leaf_sum": [127.14492192254477, 88.0967995823901,
74.80948866187643, 39.97951092473685, 56.474254685331886,
43.980569251964646, 37.7737695499769, 35.65929391798582, 27.135217869478836,
37.09788337603027, 19.779710319353367, 19.54372752189835,
13.053396805503834, 25.388641820286416, 14.39876500208645,
19.744726798699855, 36.16125203295685, 13.065565036180562,
31.65522880259975, 12.467075924043504, 14.569212696197317,
19.898053549465228, 26.083041650032033, 23.78962321440067,
13.613781002882185, 23.480344105179555, 10.332821548849548,
15.260340870726324, 18.8964057793084, 13.50750383341732, 22.168444574092227,
17.813660761381108, 15.210725842732755, 16.813001152491406,
21.838958557460664, 23.526322557245997, 25.268501988441894,
20.44180021965354, 12.100801474744053, 24.39171515580616,
15.482800751014082, 19.733959990150293, 21.042629708156745,
18.855322787238507, 16.872661122060315, 19.407220759979527,
16.574887988519695, 20.42741769851277, 17.106728170731778,
26.678910188033793, -11.975862463769783, -11.981942596620852,
-11.986395119875015, -11.98967891943462, -11.992116912072362,
-11.993938483256082, -11.995307917015868, -11.996343724175862,
-11.997131949553534, -11.997735433910897, -9.72784895382232,
-10.064892392671641, -10.231823287164612, -10.325958561677503,
-10.383188342263221, -10.419719224708132, -10.443841990259651,
-10.460171431731776, -10.471435959904147, -10.479322579588263], "nodes":
[55, 59, 61, 57, 59, 63, 63, 61, 59, 63, 63, 63, 59, 63, 63, 63, 57, 63, 63,
63, 63, 61, 63, 63, 63, 63, 63, 61, 61, 63, 63, 63, 63, 63, 63, 63, 61, 63,
63, 63, 61, 63, 63, 63, 59, 63, 63, 63, 63, 63, 63, 63, 59, 63, 63, 63, 59,
61, 63, 63, 63, 63, 63, 63, 59, 63, 61, 63, 61, 61, 61, 63, 61, 61, 63, 63,
63, 63, 63, 63, 57, 61, 63, 61, 61, 63, 61, 63, 59, 63, 55, 63, 63, 61, 63,
63, 57, 63, 63, 61, 57, 61, 63, 59, 61, 63, 61, 63, 59, 61, 49, 61, 57, 63,
63, 61, 55, 63, 63, 61, 61, 63, 55, 63, 51, 63, 57, 57, 59, 61, 59, 63, 61,
63, 61, 61, 61, 61, 63, 59, 61, 61, 59, 61, 55, 61, 61, 63, 55, 63, 63, 63,
59, 61, 57, 59, 61, 63, 63, 61, 63, 61, 63, 61, 57, 59, 59, 61, 59, 63, 63,
61, 63, 63, 63, 61, 63, 63, 63, 63, 55, 63, 57, 61, 63, 63, 59, 63, 63, 63,
61, 63, 63, 63, 63, 59, 53, 63, 63, 57, 15, 21, 19, 17, 15, 21, 19, 17, 15,
21, 19, 17, 15, 21, 19, 17, 15, 21, 19, 17, 15, 21, 19, 17, 15, 21, 19, 17,
15, 21, 19, 17, 15, 21, 19, 17, 15, 21, 19, 17, 19, 17, 17, 15, 19, 17, 17,
15, 19, 17, 17, 15, 19, 17, 17, 15, 19, 17, 17, 15, 19, 17, 17, 15, 19, 17,
17, 15, 19, 17, 17, 15, 19, 17, 17, 15, 19, 17, 17, 15], "predict": [0, 1,
3, 0, 3, 2, 1, 3, 2, 2, 1, 0, 0, 2, 1, 3, 3, 3, 2, 2, 2, 0, 1, 3, 2, 0, 1,
0, 0, 1, 1, 2, 0, 2, 1, 2, 0, 0, 2, 2, 3, 2, 3, 2, 0, 1, 2, 3, 3, 2, 2, 3,
3, 3, 1, 3, 1, 3, 0, 1, 3, 2, 1, 3], "proba_sum": [13.543032437125586,
13.706775416545655, 18.546605537340184, 18.203586608988573]}]}
""")


def make_inputs(m, n, k_frames, n_feat, n_class, seed):
    """bench.py::make_inputs: standard-normal frames, softmax-linear members."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k_frames, n_feat), np.float32)
    w = (rng.standard_normal((m, n_feat, n_class), np.float32)
         / np.float32(np.sqrt(n_feat)))
    b = rng.standard_normal((m, n_class), np.float32) * np.float32(0.1)
    return x, w, b


def oracle_entropy(x, w, b):
    """float64 reference chain: per-frame softmax, frame mean, member mean,
    entropy (amg_test.py:428-447 for linear members)."""
    n, k_frames, n_feat = x.shape
    frames = x.reshape(n * k_frames, n_feat).astype(np.float64)
    per_member = []
    for m in range(w.shape[0]):
        logits = frames @ w[m] + b[m]
        logits -= logits.max(axis=1, keepdims=True)
        p = np.exp(logits)
        p /= p.sum(axis=1, keepdims=True)
        per_member.append(p.reshape(n, k_frames, -1).mean(axis=1))
    p = np.mean(per_member, axis=0)
    p /= p.sum(axis=1, keepdims=True)
    return -np.sum(np.where(p > 0, p * np.log(np.where(p > 0, p, 1)), 0),
                   axis=1)


def check_entropy(got, ref, what):
    """Same -inf rows, finite elsewhere, within the gate; returns the max
    absolute error over the finite rows."""
    g, r = got.double().cpu().numpy(), ref.double().cpu().numpy()
    if g.shape != r.shape:
        raise AssertionError(f"{what}: shape {g.shape} != {r.shape}")
    if not np.array_equal(np.isneginf(g), np.isneginf(r)):
        raise AssertionError(f"{what}: -inf rows differ")
    live = ~np.isneginf(r)
    if not np.all(np.isfinite(g[live])):
        raise AssertionError(f"{what}: non-finite entropy on a valid row")
    np.testing.assert_allclose(g[live], r[live], rtol=RTOL, atol=ATOL,
                               err_msg=what)
    return float(np.max(np.abs(g[live] - r[live]), initial=0.0))


def check_selection(got, ref, ent_got, ent_ref, what):
    """Top-k slots agree where values > -inf.  Returns how many slots name
    another song; each such slot must be a near-tie: both sides' values
    agree within the gate, and each pick scores the same on the other
    side's entropies."""
    v, i = (t.cpu().numpy() for t in got)
    rv, ri = (t.cpu().numpy() for t in ref)
    live = rv > -np.inf
    if not np.array_equal(v > -np.inf, live):
        raise AssertionError(f"{what}: valid slots differ")
    np.testing.assert_allclose(v[live], rv[live], rtol=RTOL, atol=ATOL,
                               err_msg=what)
    differ = live & (i != ri)
    if differ.any():
        eg, er = ent_got.cpu().numpy(), ent_ref.cpu().numpy()
        np.testing.assert_allclose(er[i[differ]], rv[differ], rtol=RTOL,
                                   atol=ATOL, err_msg=what + " (near-tie)")
        np.testing.assert_allclose(eg[ri[differ]], v[differ], rtol=RTOL,
                                   atol=ATOL, err_msg=what + " (near-tie)")
    return int(differ.sum())


def phase_device(quiet=False):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    if not quiet:
        print(f"[device] torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
              f"{torch.cuda.device_count()} device(s)")
        print(card)
    return card


def tensor_core_instructions(name):
    """Lines of ``cuobjdump -sass`` on the built library that hold HGMMA
    (wgmma) or HMMA (mma.sync) instructions."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.library_path(name)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return {op: sum(f" {op}." in line or f" {op} " in line
                    for line in sass.splitlines())
            for op in ("HGMMA", "HMMA")}


def phase_build():
    t0 = time.perf_counter()
    logs = build.build_all()
    wall = time.perf_counter() - t0
    print(f"[build] {', '.join(logs)} built in {wall:.3f} s")
    for name, log in logs.items():
        # ptxas -v: per instantiation (wgmma width N), registers and spills.
        for block in log.split("Compiling entry function")[1:]:
            width = re.search(r"ILi(\d+)E", block)
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            print(f"[build] {name} N={width and width.group(1)}: "
                  f"{regs and regs.group(1)} registers, "
                  f"{spill and spill.group(1)} B of spill stores")
        for line in log.splitlines():
            if "arning" in line or "C75" in line:
                print(f"[build] {name}: {line.strip()[:160]}")
    tc = tensor_core_instructions("linear_mc")
    print(f"[build] linear_mc SASS: {tc['HGMMA']} HGMMA, {tc['HMMA']} HMMA "
          f"instructions")
    if not tc["HGMMA"] + tc["HMMA"]:
        raise AssertionError("linear_mc: no tensor-core instruction in SASS")


def _case(name, m, n, k_frames, n_feat, n_class, k, seed, mask=None,
          dup=None, weights=None):
    """One small case; ``dup`` copies the highest-entropy row to those
    positions, and the case then expects every valid copy first, in index
    order (exact ties across tiles, lowest index wins)."""
    x, w, b = make_inputs(m, n, k_frames, n_feat, n_class, seed)
    if weights is not None:
        x, w, b = weights
    mask = np.ones(n, bool) if mask is None else mask
    expect_top = None
    if dup is not None:
        best = int(np.argmax(oracle_entropy(x, w, b)))
        x[dup] = x[best]
        expect_top = sorted(p for p in set(dup) | {best} if mask[p])
    return name, x, w, b, mask, k, expect_top


def small_cases():
    rng = np.random.default_rng(SEED)
    masked_tile = np.ones(1200, bool)
    masked_tile[256:384] = False                  # a whole 128-song tile
    sparse = np.zeros(300, bool)
    sparse[[2, 5, 9, 290]] = True                 # fewer valid rows than k
    x_far = np.zeros((16, 1, 8), np.float32)
    x_far[:, 0, 0] = 1.0
    w_far = np.zeros((2, 8, 4), np.float32)
    w_far[0, 0] = [0.0, 0.0, 0.0, 80.0]           # huge logits
    w_far[1, 0] = [0.0, 0.0, 0.0, 5.0]            # far below them
    return [
        _case("uneven", 3, 50, 2, 12, 4, 8, 1),
        _case("ties+masked tile", 3, 1200, 2, 12, 4, 6, 2, mask=masked_tile,
              dup=[5, 130, 500, 1000, 1199]),
        _case("fewer valid than k", 2, 300, 1, 12, 4, 5, 3, mask=sparse),
        _case("member far below max", 2, 16, 1, 8, 4, 3, 4,
              weights=(x_far, w_far, np.zeros((2, 4), np.float32))),
        _case("C=3", 5, 700, 3, 37, 3, 10, 5, mask=rng.random(700) > 0.2),
        _case("C=8 K=5 F=70", 4, 260, 5, 70, 8, 10, 6),
        _case("M=64", 64, 500, 2, 20, 4, 10, 7),
        _case("M=1", 1, 300, 3, 16, 4, 10, 8),
        _case("k=128", 3, 200, 1, 12, 4, 128, 9),
        _case("bench widths", 16, 2000, 4, 260, 4, 10, 10,
              mask=rng.random(2000) > MASKED_SHARE),
    ]


def check_split(err, what):
    """The 3xTF32 product's error at bench widths (see SPLIT_MAX_ERR)."""
    if err > SPLIT_MAX_ERR:
        raise AssertionError(f"{what}: max |err| {err:.3e} > {SPLIT_MAX_ERR}"
                             f", more than three TF32 products give")


def phase_small():
    worst = {}
    cases = small_cases()
    for name, x, w, b, mask, k, expect_top in cases:
        m = w.shape[0]
        xt = torch.from_numpy(x).cuda()
        w_p, b_p = linear_members_from_jax(w, b, "cuda")
        mt = torch.from_numpy(mask).cuda()
        plain = linear_mc.plain_masked_entropy(xt, w_p, b_p, mt, m)
        ref = masked_top_k(plain, mt, k)
        for fuse in (False, True):
            ent, v, i = linear_mc.linear_score_mc(
                xt, w_p, b_p, mt, n_members=m, k=k, fuse_topk=fuse)
            torch.cuda.synchronize()
            what = f"{name}, fuse_topk={fuse}"
            worst[name] = max(worst.get(name, 0.0),
                              check_entropy(ent, plain, what))
            if check_selection((v, i), ref, ent, plain, what):
                raise AssertionError(f"{what}: indices differ")
            top = i[:len(expect_top or [])].tolist()
            if expect_top is not None and top != expect_top:
                raise AssertionError(f"{what}: tie order {top}")
        if name == "uneven":
            np.testing.assert_allclose(ent.cpu().numpy(),
                                       oracle_entropy(x, w, b), rtol=RTOL,
                                       atol=ATOL, err_msg="float64 oracle")
    check_split(worst["bench widths"], "bench widths")
    print(f"[small] {len(cases)} cases x fuse_topk {{False, True}}: "
          f"kernel == plain, indices equal, max |err| "
          f"{max(worst.values()):.3e}, at bench widths "
          f"{worst['bench widths']:.3e} (<= {SPLIT_MAX_ERR})")


def phase_full(x, w, b, mask):
    xt = torch.from_numpy(x).cuda()
    w_p, b_p = linear_members_from_jax(w, b, "cuda")
    mt = torch.from_numpy(mask).cuda()
    plain = linear_mc.plain_masked_entropy(xt, w_p, b_p, mt, M)
    ref = masked_top_k(plain, mt, Q)
    worst, differ = 0.0, {}
    for fuse in (False, True):
        ent, v, i = linear_mc.linear_score_mc(xt, w_p, b_p, mt, n_members=M,
                                              k=Q, fuse_topk=fuse)
        torch.cuda.synchronize()
        if ent.shape != (N,) or v.shape != (Q,) or i.shape != (Q,):
            raise AssertionError("full width: output shapes")
        what = f"full width, fuse_topk={fuse}"
        worst = max(worst, check_entropy(ent, plain, what))
        differ[fuse] = check_selection((v, i), ref, ent, plain, what)
    check_split(worst, "full width")
    print(f"[full] M={M} N={N} K={K} F={F} C={C} k={Q}, "
          f"{int((~mask).sum())} rows masked: max |err| {worst:.3e} "
          f"(<= {SPLIT_MAX_ERR}), "
          f"near-tie slots naming another song {differ}")
    return xt, w_p, b_p, mt, worst


def phase_slice(x, w, b):
    kern = LinearPoolScorer(x, w, b, impl="kernel")
    plain = LinearPoolScorer(x, w, b, impl="plain")
    torch.cuda.synchronize()
    linear_mc.launches = 0
    t0 = time.perf_counter()
    got = [kern.step(Q) for _ in range(ITERS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = linear_mc.launches
    ref = [plain.step(Q) for _ in range(ITERS)]
    torch.cuda.synchronize()
    # The weights are fixed, so each side selects its own entropies in
    # descending order; once a near-tie splits, the masks differ, so a pick
    # is checked against the other side's first (unmasked) entropies.
    differ = 0
    for it, (g, r) in enumerate(zip(got, ref)):
        differ += check_selection((g.values, g.indices),
                                  (r.values, r.indices), got[0].entropy,
                                  ref[0].entropy, f"slice iteration {it}")
        if not bool((g.values > -np.inf).all()):
            raise AssertionError(f"slice iteration {it}: a -inf selection")
    for name, steps in (("kernel", got), ("plain", ref)):
        ids = torch.cat([s.indices for s in steps]).unique()
        if ids.numel() != ITERS * Q:
            raise AssertionError(f"slice: {name} selected a song twice")
    left = int(kern.pool_mask.sum()), int(plain.pool_mask.sum())
    if left != (N - ITERS * Q,) * 2:
        raise AssertionError(f"slice: masks count {left}")
    if launches != ITERS:
        raise AssertionError(f"slice: {launches} kernel launches for "
                             f"{ITERS} iterations")
    print(f"[slice] {ITERS} iterations x q={Q}: selections agree "
          f"({differ} near-tie slots name another song), masks count "
          f"{left[0]}, kernel launches {launches}, "
          f"{wall / ITERS * 1e3:.3f} ms per iteration (host clock)")
    return launches, kern


def time_ms(fn, reps=REPS):
    """Median of ``reps`` calls, each bracketed by CUDA events."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def time_loop_ms(fn):
    """Per-call time of LOOP_CALLS back-to-back calls between one pair of
    CUDA events, median of LOOP_ROUNDS rounds."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(LOOP_ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LOOP_CALLS):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / LOOP_CALLS)
    return statistics.median(per_call)


def bounds_ms():
    """The least time one launch could take at the slice's shapes, two ways:
    the float32 design (the product on the CUDA cores) and this kernel's
    (3xTF32 on the tensor cores), each the larger of bytes and operations.
    Each input is read once and each output written once."""
    mc = M * C
    n_tiles = -(-N // linear_mc.TILE_SONGS)
    n_bytes = (4 * (N * K * F + F * mc + mc) + N + 4 * N
               + n_tiles * Q * (4 + 8))
    gemm_flop = 2 * N * K * F * mc
    # The per-logit softmax work (bias, mean, shift, clamp, exp, sum,
    # divide, accumulate) counted as 8 operations, on the CUDA cores.
    softmax_flop = 8 * N * K * mc
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    f32_ms = (gemm_flop + softmax_flop) / PEAK_F32_FLOP_S * 1e3
    tf32_ms = (3 * gemm_flop / PEAK_TF32_FLOP_S
               + softmax_flop / PEAK_F32_FLOP_S) * 1e3
    return {"bytes": n_bytes, "bytes_ms": bytes_ms,
            "f32_flop": gemm_flop + softmax_flop, "f32_ms": f32_ms,
            "tf32_flop": 3 * gemm_flop + softmax_flop, "tf32_ms": tf32_ms,
            "bound_f32_ms": max(bytes_ms, f32_ms),
            "bound_ms": max(bytes_ms, tf32_ms),
            "bound_by": "bytes" if bytes_ms >= tf32_ms else "operations"}


def phase_times(xt, w_p, b_p, mt, scorer, card):
    n_tiles = -(-N // linear_mc.TILE_SONGS)
    x2d = xt.view(N * K, F)
    kernel0 = time_ms(lambda: linear_mc._launch(xt, w_p, b_p, mt, M, 0))
    kernel_k = time_ms(lambda: linear_mc._launch(xt, w_p, b_p, mt, M, Q))
    wrapper = time_ms(lambda: linear_mc.linear_score_mc(
        xt, w_p, b_p, mt, n_members=M, k=Q, fuse_topk=True))
    plain = time_ms(lambda: masked_top_k(
        linear_mc.plain_masked_entropy(xt, w_p, b_p, mt, M), mt, Q))
    library = time_ms(lambda: torch.matmul(x2d, w_p))
    flat_v = linear_mc._launch(xt, w_p, b_p, mt, M, Q)[1].reshape(-1)
    merge = time_loop_ms(lambda: masked_top_k(
        flat_v, torch.ones_like(flat_v, dtype=torch.bool), Q))
    _, values, indices = linear_mc.linear_score_mc(
        xt, w_p, b_p, mt, n_members=M, k=Q, fuse_topk=True)
    spare = mt.clone()
    update = time_loop_ms(lambda: reveal_mask_update(spare, values, indices))
    # One AL iteration of the slice as the user runs it (the mask keeps
    # shrinking: STEP_REPS + 5 more steps of q songs).
    step = time_ms(lambda: scorer.step(Q), STEP_REPS)
    bd = bounds_ms()
    print(f"[times] {card}: kernel n_cand=0 {kernel0:.4f} ms, n_cand={Q} "
          f"{kernel_k:.4f} ms, wrapper with merge {wrapper:.4f} ms, plain "
          f"(entropy + top-k) {plain:.4f} ms, library torch.matmul "
          f"(N*K, F) @ (F, M*C) alone {library:.4f} ms")
    print(f"[times] slice step (kernel, merge of {n_tiles * Q} candidates, "
          f"mask update) {step:.4f} ms over {STEP_REPS}; step - kernel "
          f"{step - kernel_k:.4f} ms; per call over {LOOP_CALLS} back to "
          f"back (median of {LOOP_ROUNDS}; host dispatch, varies with the "
          f"host's load): merge {merge:.4f} ms, mask update {update:.4f} ms")
    print(f"[times] per launch {bd['bytes']} B ({bd['bytes_ms']:.4f} ms at "
          f"3.35 TB/s); float32 design {bd['f32_flop']} FLOP "
          f"({bd['f32_ms']:.4f} ms at 67 TFLOP/s): bound "
          f"{bd['bound_f32_ms']:.4f} ms, kernel at "
          f"{bd['bound_f32_ms'] / kernel_k:.1%} of it")
    print(f"[times] 3xTF32 design: {bd['tf32_flop']} FLOP ({bd['tf32_ms']:.4f}"
          f" ms: 3 products at 495 TFLOP/s, softmax at 67 TFLOP/s): bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}; kernel at "
          f"{bd['bound_ms'] / kernel_k:.1%} of it")
    # The merge and the mask update are host dispatch: they move by up to
    # 1.9x between runs on a shared host, so they stay out of the table.
    return {"ms": kernel_k, "ms_n_cand_0": kernel0, "plain_ms": plain,
            "bound_ms": bd["bound_ms"], "bound_f32_ms": bd["bound_f32_ms"],
            "bound_by": bd["bound_by"], "library_ms": library,
            "step_ms": step}


def make_member_params(seed=SEED):
    """The closed-form committee's parameters: GaussianNB theta ~ N(0, 0.5^2),
    var ~ U(0.5, 2), priors from a flat Dirichlet; SGD-logistic coef ~
    N(0, 1/F), intercept ~ N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.5, (G_MEMBERS, C, F)).astype(np.float32),
            rng.uniform(0.5, 2.0, (G_MEMBERS, C, F)).astype(np.float32),
            np.log(rng.dirichlet(np.ones(C), G_MEMBERS)).astype(np.float32),
            rng.normal(0, F ** -0.5, (S_MEMBERS, C, F)).astype(np.float32),
            rng.normal(0, 0.1, (S_MEMBERS, C)).astype(np.float32))


def make_hc_table(n_pool, n_class, seed=HC_SEED):
    """bench.py::make_hc_table: annotator quadrant frequencies, 3 decimals."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 20, size=(n_pool, n_class)).astype(np.float64)
    counts[:, 0] += 1
    freq = counts / counts.sum(axis=1, keepdims=True)
    return np.round(freq, 3).astype(np.float32)


def oracle_member_probs(x, params):
    """float64 numpy of the same formulas: per-frame GaussianNB posteriors
    and OvA sigmoids (L1-normalised), then the mean over each song's K
    frames -> (G+S, N, C)."""
    theta, var, log_prior, coef, intercept = (p.astype(np.float64)
                                              for p in params)
    n, k_frames, n_feat = x.shape
    frames = x.reshape(n * k_frames, n_feat).astype(np.float64)
    squares = frames * frames
    out = []
    for g in range(theta.shape[0]):
        inv_var = 1.0 / var[g]
        jll = (log_prior[g] - 0.5 * np.log(2 * np.pi * var[g]).sum(1)
               - 0.5 * (squares @ inv_var.T
                        - 2.0 * frames @ (theta[g] * inv_var).T
                        + (theta[g] ** 2 * inv_var).sum(1)))
        jll -= jll.max(axis=1, keepdims=True)
        p = np.exp(jll)
        out.append(p / p.sum(axis=1, keepdims=True))
    for s in range(coef.shape[0]):
        p = 1.0 / (1.0 + np.exp(-(frames @ coef[s].T + intercept[s])))
        out.append(p / p.sum(axis=1, keepdims=True))
    return np.stack([p.reshape(n, k_frames, -1).mean(axis=1) for p in out])


def phase_members(x):
    """The device-member committee over the slice's pool on the card."""
    params = make_member_params()
    committee = DeviceMemberCommittee(device_members_from_numpy(*params))
    pool = FramePool(x.reshape(N * K, F), np.repeat(np.arange(N), K))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    table = committee.score_pool(pool)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if table.shape != (G_MEMBERS + S_MEMBERS, N, C):
        raise AssertionError(f"members: shape {tuple(table.shape)}")
    got = table.double().cpu().numpy()
    if not np.isfinite(got).all():
        raise AssertionError("members: non-finite probabilities")
    ref = oracle_member_probs(x, params)
    gnb, sgd = slice(0, G_MEMBERS), slice(G_MEMBERS, None)
    np.testing.assert_allclose(got[gnb], ref[gnb], **GNB_TOL,
                               err_msg="members: GaussianNB vs oracle")
    np.testing.assert_allclose(got[sgd], ref[sgd], **SGD_TOL,
                               err_msg="members: SGD-OvA vs oracle")
    err = {kind: float(np.abs(got[sl] - ref[sl]).max())
           for kind, sl in (("gnb", gnb), ("sgd", sgd))}
    live = np.sort(np.random.default_rng(SEED).choice(N, 300, replace=False))
    staged = committee.pool_probs(pool, live.tolist(), pad_to=512)
    want = table.index_select(1, torch.from_numpy(live).to(table.device))
    if not (torch.equal(staged[:, :300], want)
            and torch.equal(staged[:, 300:],
                            want[:, -1:].expand(-1, 212, -1))):
        raise AssertionError("members: pool_probs columns or staging tail")
    print(f"[members] {G_MEMBERS} GaussianNB + {S_MEMBERS} SGD-OvA over "
          f"N={N} songs x K={K} frames, F={F}: (16, N, C) within the "
          f"oracle's tolerances, max |err| GNB {err['gnb']:.3e}, SGD "
          f"{err['sgd']:.3e}; staged columns and tail exact")
    return committee, pool, table, {"peak": peak, "base": base, **err}


def _select(acq, probs=None):
    """``Acquirer.select`` through its seam, keeping the scoring result."""
    fn_key, inputs = acq.scoring_inputs(probs)
    res = acq.run_scoring(fn_key, inputs)
    return acq.finish_select(res), res


def _twins_match(acq):
    d = acq.device
    ok = np.array_equal(d.pool_mask.cpu().numpy(), acq.pool_mask)
    if acq.strategy.uses_hc_table:
        ok &= np.array_equal(d.hc_mask.cpu().numpy(), acq.hc_mask)
    return ok


def _compare_slots(card, host, what, rtol=RTOL, atol=ATOL):
    """Card and CPU results of one select: same valid slots, values within
    the gate (or the given tolerance); returns how many slots name another
    row (near-ties)."""
    v, i = card.values.cpu().numpy(), card.indices.cpu().numpy()
    rv, ri = host.values.numpy(), host.indices.numpy()
    live = rv > -np.inf
    if not np.array_equal(v > -np.inf, live):
        raise AssertionError(f"{what}: valid slots differ")
    np.testing.assert_allclose(v[live], rv[live], rtol=rtol, atol=atol,
                               err_msg=what)
    return int((live & (i != ri)).sum())


def run_pair(mode, tables, hc, fuse, weights=None):
    """A card and a CPU ``Acquirer`` through ITERS selects on the same probs
    (each gathers its own live columns of the table on its device)."""
    songs = list(range(N))
    card = Acquirer(songs, hc, queries=Q, mode=mode, seed=SEED,
                    fuse_step=fuse)
    host = Acquirer(songs, hc, queries=Q, mode=mode, seed=SEED,
                    fuse_step=fuse, device="cpu")
    table = tables.get("qbdc" if mode == "qbdc" else "members")
    near, card_ids = 0, []
    for it in range(ITERS):
        out = []
        for acq in (card, host):
            if weights is not None:
                acq.member_weights = weights[it]
            probs = None
            if acq.strategy.needs_probs:
                t = table[acq.torch_device.type]
                probs = t.index_select(1, torch.from_numpy(
                    np.flatnonzero(acq.pool_mask)).to(t.device))
            out.append(_select(acq, probs))
        (ids, res), (host_ids, host_res) = out
        what = f"acquire {mode} fuse_step={fuse} iteration {it}"
        for r in (res, host_res):
            if int(valid_count(r.values)) != Q:
                raise AssertionError(f"{what}: valid_count != {Q}")
        if mode == "rand":
            if not (ids == host_ids and torch.equal(res.values.cpu(),
                                                    host_res.values)):
                raise AssertionError(f"{what}: rand draws differ")
        near += _compare_slots(res, host_res, what)
        card_ids.append(res.indices.cpu())
    if fuse and not (_twins_match(card) and _twins_match(host)):
        raise AssertionError(f"acquire {mode}: device masks != host masks")
    return card_ids, near


def phase_acquire(table):
    """All six modes, card against CPU, on the member table (qbdc: a
    seeded table of K dropout forwards)."""
    hc = make_hc_table(N, C)
    qbdc = np.random.default_rng(SEED + 2).dirichlet(
        np.ones(C), (QBDC_K, N)).astype(np.float32)
    tables = {"members": {"cuda": table, "cpu": table.cpu()},
              "qbdc": {"cuda": torch.from_numpy(qbdc).cuda(),
                       "cpu": torch.from_numpy(qbdc)}}
    fns = make_scoring_fns(k=Q)
    full = torch.ones(N, dtype=torch.bool, device=table.device)
    mc = fns["mc"](table, full)
    wmc = fns["wmc"](table, full, torch.ones(table.shape[0],
                                             device=table.device))
    if not all(torch.equal(a, b) for a, b in zip(mc, wmc)):
        raise AssertionError("acquire: equal-weight wmc != mc on the card")
    weights = np.random.default_rng(SEED + 3).uniform(
        0.05, 1.0, (ITERS, table.shape[0])).astype(np.float32)
    linear_mc.launches = 0
    near, ids = {}, {}
    for mode in acquire.available_modes():
        ids[mode], near[mode] = run_pair(
            mode, tables, hc, True, weights if mode == "wmc" else None)
    _, near["mc unfused"] = run_pair("mc", tables, hc, False)
    launches = linear_mc.launches
    if launches:
        raise AssertionError(f"acquire: {launches} linear_mc launches")
    reordered = sum(int((a != b).sum()) for a, b in zip(ids["wmc"], ids["mc"]))
    if not reordered:
        raise AssertionError("acquire: wmc weights reordered no slot vs mc")
    print(f"[acquire] 6 modes x {ITERS} fused selects of q={Q} at N={N}, "
          f"card vs CPU on the same probs (mc also unfused): valid_count "
          f"{Q} every select, rand ids equal, slots naming another song "
          f"(near-ties within the gate) {near}; equal-weight wmc == mc bit "
          f"for bit; random weights moved {reordered} wmc slots vs mc; "
          f"device masks == host masks; kernel launches on this path "
          f"{launches} (it runs no hand kernel)")
    return tables, hc


def busy_share(prof, n_units, window_s=None):
    """The union of a stopped profile's device-side intervals (kernels and
    copies), as a share of ``window_s`` (by default the span of all its
    events) and in ms per unit of work; ``None`` when the profiler
    recorded no device time."""
    events = prof.profiler.kineto_results.events()
    spans = sorted((e.start_ns(), e.end_ns()) for e in events
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, end = 0, -1
    for lo, hi in spans:
        busy += max(0, hi - max(lo, end))
        end = max(end, hi)
    if window_s is None:
        window_s = (max(e.end_ns() for e in events)
                    - min(e.start_ns() for e in events)) / 1e9
    return busy / 1e9 / window_s, busy / 1e6 / n_units


def device_busy(acq, probs):
    """Profile PROFILED_SELECTS selects (see ``busy_share``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_SELECTS):
            acq.select(probs)
        torch.cuda.synchronize()
    return busy_share(prof, PROFILED_SELECTS)


def member_bounds():
    """The member pass's least time: bytes (frames, parameters, the frame
    -> song index, the table written) and float32 operations (the three
    GEMM families of F-long dot products, on the CUDA cores)."""
    m, n_frames = G_MEMBERS + S_MEMBERS, N * K
    n_bytes = (4 * n_frames * F + 4 * (3 * G_MEMBERS + 2 * S_MEMBERS) * C * F
               + 8 * n_frames + 4 * m * N * C)
    flop = 2 * n_frames * F * C * (2 * G_MEMBERS + S_MEMBERS)
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    flop_ms = flop / PEAK_F32_FLOP_S * 1e3
    return n_bytes, bytes_ms, flop, flop_ms


def phase_acquire_times(committee, pool, tables, hc, mem, card):
    table = tables["members"]["cuda"]
    member_ms = time_ms(lambda: committee.score_pool(pool))
    n_bytes, bytes_ms, flop, flop_ms = member_bounds()
    bound = max(bytes_ms, flop_ms)
    print(f"[acq-times] {card}: member pass (16, N={N}, C) {member_ms:.4f} ms"
          f" (median of {REPS}); bound {bound:.4f} ms by "
          f"{'bytes' if bytes_ms >= flop_ms else 'operations'} ({n_bytes} B"
          f" = {bytes_ms:.4f} ms at 3.35 TB/s; {flop} FLOP = {flop_ms:.4f} ms"
          f" at 67 TFLOP/s), pass at {bound / member_ms:.1%} of it; peak "
          f"device memory {mem['peak'] / 2**20:.1f} MiB, "
          f"{(mem['peak'] - mem['base']) / 2**20:.1f} MiB above the "
          f"{mem['base'] / 2**20:.1f} MiB held before the phase")
    per_mode, busy = {}, {}
    for mode in acquire.available_modes():
        acq = Acquirer(list(range(N)), hc, queries=Q, mode=mode, seed=SEED)
        t = tables["qbdc" if mode == "qbdc" else "members"]["cuda"]
        # the table at full width: its first n_live columns stand for the
        # live songs, the same work as the loop's gather, without it
        probs = t if acq.strategy.needs_probs else None
        for _ in range(SELECT_WARMUP):
            acq.select(probs)
        rounds = []
        for _ in range(SELECT_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SELECT_REPS):
                acq.select(probs)
            torch.cuda.synchronize()
            rounds.append((time.perf_counter() - t0) / SELECT_REPS * 1e3)
        per_mode[mode] = (statistics.median(rounds), min(rounds), max(rounds))
        busy[mode] = device_busy(acq, probs)
    print(f"[acq-times] {card}: ms per Acquirer.select, fused, N={N}, q={Q} "
          f"(host clock over {SELECT_REPS} selects ending in a synchronize, "
          f"median of {SELECT_ROUNDS} rounds (min-max), after "
          f"{SELECT_WARMUP}): " + ", ".join(
              f"{m} {v[0]:.4f} ({v[1]:.4f}-{v[2]:.4f})"
              for m, v in per_mode.items()))
    print(f"[acq-times] {card}: device busy share over {PROFILED_SELECTS} "
          f"selects (torch.profiler; device ms per select): " + (
              "not measured (no device events)" if busy["mc"] is None
              else ", ".join(f"{m} {b[0]:.1%} ({b[1]:.4f} ms)"
                             for m, b in busy.items())))
    share = busy["mc"] and busy["mc"][0]
    return member_ms, per_mode, share



def labelled_rows(rng, centers, n):
    """``n`` frames around the class centres, every class present."""
    y = np.arange(n) % C
    rng.shuffle(y)
    x = (rng.standard_normal((n, centers.shape[1]), np.float32)
         + centers[y])
    return x.astype(np.float32), y


def fit_members(centers, n_each, seed):
    """``n_each`` GaussianNB and ``n_each`` SGD members, each fitted by the
    port's own ``fit`` on its own seeded labelled draw."""
    members = []
    for i in range(n_each):
        x, y = labelled_rows(np.random.default_rng(seed + i), centers,
                             GNB_FIT_ROWS)
        members.append(GNBMember(f"gnb.it_{i}").fit(x, y))
    for i in range(n_each):
        x, y = labelled_rows(np.random.default_rng(seed + 100 + i), centers,
                             SGD_FIT_ROWS)
        members.append(SGDMember(f"sgd.it_{i}", seed=i).fit(x, y))
    return members


class IterTimer(StepTimer):
    """``StepTimer`` recording each iteration's wall time (between flushes)
    and tracing one (``profile_epoch``) with ``torch.profiler``, device
    activity only; ``busy`` is then the union of the device's kernel and
    copy intervals, as a share of that iteration's wall time and in ms."""

    def __init__(self, profile_epoch=None):
        super().__init__(None)
        self.t = time.perf_counter()
        self.profile_epoch = profile_epoch
        self.prof, self.busy = None, None

    def flush(self, **labels):
        epoch = labels.get("epoch")
        traced = self.prof is not None and epoch == self.profile_epoch
        if traced:
            torch.cuda.synchronize()
        rec = super().flush(**labels)
        rec["iteration_s"] = time.perf_counter() - self.t
        if traced:
            self.prof.stop()
            self.busy = busy_share(self.prof, 1, rec["iteration_s"])
            self.prof = None
        if self.profile_epoch is not None and epoch == self.profile_epoch - 1:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
        # the next iteration starts here: the trace's processing is not
        # part of any iteration
        self.t = time.perf_counter()
        return rec


@contextlib.contextmanager
def recorded_scoring():
    """Yields a list that gathers every scoring result an ``Acquirer``
    returns while the block runs."""
    picks, run = [], Acquirer.run_scoring

    def recording(acq, fn_key, inputs):
        res = run(acq, fn_key, inputs)
        picks.append(res)
        return res

    Acquirer.run_scoring = recording
    try:
        yield picks
    finally:
        Acquirer.run_scoring = run


def run_al_user(mode, committee, data, path, device, epochs, timer,
                retrain_epochs=None):
    """One user's ``ALLoop.run_user``, recording every scoring result the
    acquirer returns; returns (scoring results, result)."""
    os.makedirs(path)
    loop = ALLoop(ALConfig(queries=Q, epochs=epochs, mode=mode,
                           train_size=TRAIN_SIZE, seed=SEED, qbdc_k=QBDC_K),
                  retrain_epochs=retrain_epochs, device=device)
    with recorded_scoring() as picks:
        return picks, loop.run_user(committee, data, path, timer=timer)


def read_metrics(path):
    """A user's ``metrics.jsonl``, the last record of each epoch."""
    with open(os.path.join(path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["epoch"]: r for r in recs if "event" not in r}


def check_al_run(mode, path, data, n_train, epochs=AL_EPOCHS,
                 n_members=G_MEMBERS + S_MEMBERS, what="al-loop"):
    """Queried songs disjoint and off the test split, the pool shrinking by
    q, finite F1s, the state committed through the last iteration."""
    mode = f"{what} {mode}"
    recs = read_metrics(path)
    if sorted(recs) != list(range(-1, epochs)):
        raise AssertionError(f"{mode}: epochs {sorted(recs)}")
    st = al_state.ALState.load(path)
    if st.next_epoch != epochs:
        raise AssertionError(f"{mode}: next_epoch {st.next_epoch}")
    test = set(st.test_songs)
    seen = set()
    for e in range(epochs):
        q = recs[e]["queried"]
        if len(q) != Q or seen & set(q) or test & set(q):
            raise AssertionError(f"{mode} iteration {e}: queried "
                                 "songs repeat or leave the train split")
        seen |= set(q)
        if recs[e]["pool_size"] != n_train - Q * (e + 1):
            raise AssertionError(f"{mode} iteration {e}: pool size "
                                 f"{recs[e]['pool_size']}")
    for e, r in recs.items():
        if len(r["f1"]) != n_members or not np.all(np.isfinite(r["f1"])):
            raise AssertionError(f"{mode} epoch {e}: F1s {r['f1']}")
    return recs


def phase_al_loop(x, card):
    """The AL loop at configs[4] scale on the card, each mode against the
    same loop on the CPU at iteration 0."""
    rng = np.random.default_rng(SEED + 4)
    centers = rng.normal(0, CENTER_SD, (C, F)).astype(np.float32)
    labels = rng.integers(0, C, N)
    frames = (x + centers[labels][:, None, :]).reshape(N * K, F)
    pool = FramePool(frames, np.repeat(np.arange(N), K))
    del frames
    data = UserData("synthetic", pool, dict(enumerate(labels.tolist())),
                    hc_rows=make_hc_table(N, C))
    t0 = time.perf_counter()
    members = fit_members(centers, G_MEMBERS, SEED + 5)
    fit_s = time.perf_counter() - t0
    n_train = int(round(TRAIN_SIZE * N))
    stats, near = {}, {}
    busy = None
    with tempfile.TemporaryDirectory() as root:
        for mode in AL_MODES:
            linear_mc.launches = 0
            timer = IterTimer(PROFILED_EPOCH if mode == "mc" else None)
            picks, res = run_al_user(
                mode, Committee(copy.deepcopy(members), device_members=True,
                                device="cuda"),
                data, os.path.join(root, mode, "cuda"), "cuda", AL_EPOCHS,
                timer)
            launches = linear_mc.launches
            if launches:
                raise AssertionError(f"al-loop {mode}: {launches} linear_mc "
                                     "launches on a path without the kernel")
            recs = check_al_run(mode, os.path.join(root, mode, "cuda"), data,
                                n_train)
            cpu_picks, _ = run_al_user(
                mode, Committee(copy.deepcopy(members), device_members=True,
                                device="cpu"),
                data, os.path.join(root, mode, "cpu"), "cpu", 1,
                StepTimer(None))
            cpu_recs = read_metrics(os.path.join(root, mode, "cpu"))
            what = f"al-loop {mode} iteration 0, card vs CPU"
            near[mode] = _compare_slots(picks[0], cpu_picks[0], what)
            if mode == "rand" and (recs[0]["queried"]
                                   != cpu_recs[0]["queried"]):
                raise AssertionError(f"{what}: rand ids differ")
            if len(picks) != AL_EPOCHS or not res["trajectory"]:
                raise AssertionError(f"al-loop {mode}: {len(picks)} selects")
            # the traced iteration runs slower: out of the medians
            iters = [r for r in timer.records
                     if r["epoch"] >= 0 and r["epoch"] != timer.profile_epoch]
            # hc and rand score no probs table: their score phase is 0
            stats[mode] = {k: statistics.median(r.get(f"{k}_s", 0.0)
                                                for r in iters) * 1e3
                           for k in TIMED_PHASES + ("iteration",)}
            stats[mode]["final_f1"] = recs[AL_EPOCHS - 1]["mean_f1"]
            if mode == "mc":
                busy = timer.busy
    print(f"[al-loop] {len(AL_MODES)} modes x {AL_EPOCHS} iterations of q={Q}"
          f" at N={N} songs x K={K} frames, F={F}, train size {TRAIN_SIZE},"
          f" committee {G_MEMBERS} GaussianNB + {S_MEMBERS} SGD (fitted by "
          f"the port's fit in {fit_s:.1f} s) scored on the card: queried "
          f"songs disjoint, pool shrinking by q, F1s finite, state at "
          f"next_epoch {AL_EPOCHS}; iteration 0 card vs CPU: rand ids equal,"
          f" slots naming another song (near-ties within the gate) {near}; "
          f"kernel launches on this path 0 (it runs no hand kernel)")
    for mode, st in stats.items():
        print(f"[al-loop] {card}: {mode} median ms per iteration "
              f"(StepTimer, host clock, over {AL_EPOCHS - (mode == 'mc')} "
              f"untraced): " + ", ".join(
                  f"{k} {st[k]:.3f}" for k in TIMED_PHASES + ("iteration",))
              + f"; final mean F1 {st['final_f1']:.4f}")
    print(f"[al-loop] {card}: device busy over mc iteration {PROFILED_EPOCH}"
          f" (torch.profiler, device events only): " + (
              "not measured (no device events)" if busy is None else
              f"{busy[0]:.2%} of the iteration, {busy[1]:.4f} ms"))
    return stats, busy


def write_amg_tree(root, seed=SEED + 6, users=AMG_USERS, feats_from=None):
    """An AMG1608-shaped tree: per-song openSMILE CSVs with the 260 feature
    columns, ``.mat`` annotations of ``users`` annotators, nothing from
    pandas.  ``feats_from``: link another tree's feature CSVs (the same
    seed draws the same songs) and write the annotations only."""
    rng = np.random.default_rng(seed)
    middle = [f"feat_{i}" for i in range(F - 2)]
    cols = [FEATURE_SLICE_START] + middle + [FEATURE_SLICE_STOP]
    feats = os.path.join(root, "amg1608", "feats")
    anno = os.path.join(root, "amg1608", "anno")
    os.makedirs(anno)
    if feats_from is None:
        os.makedirs(feats)
    else:
        os.symlink(feats_from, feats)
    centers = rng.normal(0, 2.0, (C, F)) + rng.uniform(-5, 5, F)
    song_ids = np.arange(1, AMG_SONGS + 1)
    song_class = rng.integers(0, C, AMG_SONGS)
    for sid, c in zip(song_ids, song_class):
        k = int(rng.integers(*AMG_FRAMES))
        rows = centers[c] + rng.standard_normal((k, F)) * 3.0
        if feats_from is not None:
            continue
        with open(os.path.join(feats, f"{sid}.csv"), "w", newline="") as f:
            w = csv.writer(f, delimiter=";", lineterminator="\n")
            w.writerow(["frameTime"] + cols)
            for t, row in enumerate(rows.astype(np.float32)):
                w.writerow([f"{t * 0.5:.1f}"] + [repr(float(v)) for v in row])
    lab = np.full((AMG_SONGS, users, 2), np.nan)
    for i, c in enumerate(song_class):
        a_sign = 1.0 if c in (0, 1) else -1.0
        v_sign = 1.0 if c in (0, 3) else -1.0
        for u in range(users):
            if rng.uniform() < ANNOTATE_P:
                lab[i, u] = (v_sign * rng.uniform(0.1, 1.0),
                             a_sign * rng.uniform(0.1, 1.0))
    from scipy.io import savemat

    savemat(os.path.join(anno, "AMG1608.mat"), {"song_label": lab})
    savemat(os.path.join(anno, "1608_song_id.mat"),
            {"mat_id2song_id": song_ids.reshape(-1, 1)})
    return os.path.join(root, "amg1608")


def write_registry(models_root, seed=SEED + 7):
    """5 GaussianNB + 5 SGD members fitted by the port on standardized
    seeded rows, saved as the port's member files."""
    centers = np.random.default_rng(seed).normal(0, 0.5, (C, F)).astype(
        np.float32)
    pre = os.path.join(models_root, "pretrained")
    os.makedirs(pre)
    for m in fit_members(centers, REG_MEMBERS, seed):
        m.save(os.path.join(pre, Committee.member_file(m)))


def with_epochs(args, epochs):
    """``args`` with its ``-e`` value set to ``epochs``."""
    out = list(args)
    out[out.index("-e") + 1] = str(epochs)
    return out


def run_cli(args):
    """``amg_test.main`` in this process, its chatter kept off stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = amg_test.main(args)
    if rc != 0:
        raise AssertionError(f"al-cli: main({args}) exited {rc}:\n"
                             f"{out.getvalue()[-2000:]}")
    return out.getvalue()


def users_metrics(models_root):
    users = os.path.join(models_root, "users")
    return {u: (read_metrics(os.path.join(users, u, "mc")),
                al_state.ALState.load(os.path.join(users, u, "mc")))
            for u in sorted(os.listdir(users))
            if os.path.isdir(os.path.join(users, u))}


class CliProcess:
    """A command started now, its output and errors into ``log``;
    ``finish`` waits and returns ``(exit code, log text)``, ``stop`` kills
    it if it still runs."""

    def __init__(self, cmd, cwd, env, log):
        self.log = log
        with open(log, "w") as f:
            self.proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=f,
                                         stderr=subprocess.STDOUT)

    def finish(self, timeout):
        try:
            rc = self.proc.wait(timeout)
        finally:
            self.stop()
        with open(self.log, errors="replace") as f:
            return rc, f.read()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def phase_al_cli_compare(got, ref):
    """The CLI's card and CPU runs: the same two users, the same queried
    songs and F1s every epoch, the state at CLI_EPOCHS."""
    if sorted(got) != sorted(ref) or len(got) != 2:
        raise AssertionError(f"al-cli: users {sorted(got)} vs "
                             f"{sorted(ref)}")
    for u in got:
        (m, st), (rm, rst) = got[u], ref[u]
        for e in range(-1, CLI_EPOCHS):
            # host members score and evaluate alike on both devices; the
            # selection's consensus entropy is the card's or the CPU's
            if (m[e].get("queried") != rm[e].get("queried")
                    or m[e]["f1"] != rm[e]["f1"]):
                raise AssertionError(f"al-cli user {u} epoch {e}: card "
                                     "and CPU runs differ")
        if st.next_epoch != CLI_EPOCHS:
            raise AssertionError(f"al-cli user {u}: {st.next_epoch}")


def phase_al_cli(card):
    """The CLI on the card and on the CPU, then the kill/resume drill."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        amg_root = write_amg_tree(root)
        tree_s = time.perf_counter() - t0
        roots = {d: os.path.join(root, f"models_{d}")
                 for d in ("cuda", "cpu", "killed")}
        write_registry(roots["cuda"])
        for d in ("cpu", "killed"):
            shutil.copytree(os.path.join(roots["cuda"], "pretrained"),
                            os.path.join(roots[d], "pretrained"))
        # the kill drill's subprocesses run beside the runs in this process
        base = CLI_ARGS + ["--models-root", roots["killed"], "--amg-root",
                           amg_root, "--device", "cuda"]
        cmd = [sys.executable, "-m", "consensus_entropy_tpu_torch.cli.amg_test"]
        env = dict(os.environ, PYTHONPATH=here,
                   CETPU_FAULTS="state.save:kill@2")
        drill = CliProcess(cmd + base, here, env,
                           os.path.join(root, "killed.log"))
        try:
            walls = {}
            for d in ("cuda", "cpu"):
                t0 = time.perf_counter()
                run_cli(CLI_ARGS + ["--models-root", roots[d], "--amg-root",
                                    amg_root, "--device", d])
                walls[d] = time.perf_counter() - t0
            rc, log = drill.finish(600)
            if rc == 0 or "injected kill" not in log:
                raise AssertionError(f"al-cli: the kill drill did not kill "
                                     f"(exit {rc}):\n{log[-2000:]}")
            env.pop("CETPU_FAULTS")
            drill = CliProcess(cmd + base, here, env,
                               os.path.join(root, "rerun.log"))
            got, ref = (users_metrics(roots["cuda"]),
                        users_metrics(roots["cpu"]))
            phase_al_cli_compare(got, ref)
            fleet_cli = fleet_cli_runs(root, amg_root, roots["cuda"],
                                       {"cuda": got, "cpu": ref})
            rc, log = drill.finish(600)
            if rc != 0:
                raise AssertionError(f"al-cli: the rerun exited {rc}:\n"
                                     f"{log[-2000:]}")
        finally:
            drill.stop()
        resumed = users_metrics(roots["killed"])
        for u in got:
            (m, st), (rm, rst) = got[u], resumed[u]
            if m != rm or st != rst:
                raise AssertionError(f"al-cli user {u}: the resumed run's "
                                     "metrics or state differ")
        cnn = phase_al_cli_cnn(card, root, amg_root, roots["cuda"])
        # phase 18 (d)'s and 19 (c)'s runs in this process while phase 20's
        # fabric runs (b) and (c) wait on their processes
        fabric_cli, (mesh_cli, serve_cli) = fabric_cli_runs(
            root, amg_root, cnn, roots["cuda"],
            lambda: (mesh_cli_runs(root, amg_root, cnn),
                     serve_cli_runs(root, amg_root, cnn)))
    print(f"[al-cli] {card}: amg_test {' '.join(CLI_ARGS)} on an "
          f"AMG1608-shaped tree ({AMG_SONGS} songs, {F} feature columns, "
          f"written in {tree_s:.1f} s), {REG_MEMBERS} GaussianNB + "
          f"{REG_MEMBERS} SGD members: card and CPU metrics.jsonl equal "
          f"(queried songs and F1s, every epoch) in {walls['cuda']:.1f} s / "
          f"{walls['cpu']:.1f} s; killed at state.save hit 2, the rerun "
          f"resumed to the uninterrupted run's metrics and state")
    return fleet_cli, mesh_cli, serve_cli, fabric_cli


# -- slice 5: the boosted slot and the CNN members -------------------------


def phase_gbdt(card):
    """The GBDT host core at DEAM pre-training scale: built with g++, one
    tree and a small forest's margins bit-equal to the numpy plain
    versions; then an AL member's fit, update and pool predict timed."""
    t0 = time.perf_counter()
    lib, _ = native.build()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 8)
    n = DEAM_SONGS * DEAM_FRAMES
    y = rng.integers(0, C, n)
    centers = rng.normal(0, 0.5, (C, F)).astype(np.float32)
    x = rng.standard_normal((n, F), np.float32) + centers[y]
    t0 = time.perf_counter()
    xb = QuantileBinner(GBDT_BINS).fit(x).transform(x)
    bin_s = time.perf_counter() - t0
    # the first round's class-0 gradients under the uniform start
    g = (0.25 - (y == 0)).astype(np.float32)
    h = np.full(n, 0.25 * 0.75, np.float32)
    # the first call loads the library and starts OpenMP's threads
    native.gbdt_build_tree(xb[:64], g[:64], h[:64], max_depth=GBDT_DEPTH,
                           n_bins=GBDT_BINS)
    t0 = time.perf_counter()
    tree = native.gbdt_build_tree(xb, g, h, max_depth=GBDT_DEPTH,
                                  n_bins=GBDT_BINS)
    tree_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain = native.gbdt_build_tree(xb, g, h, max_depth=GBDT_DEPTH,
                                   n_bins=GBDT_BINS, plain=True)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not all(np.array_equal(a, b) for a, b in zip(tree, plain)):
        raise AssertionError("gbdt: the core's tree differs from the plain "
                             "version's")
    forest = GBDT(C, max_depth=GBDT_DEPTH, n_bins=GBDT_BINS).boost(
        xb, y, GBDT_CHECK_ROUNDS)
    st = forest.state()
    args = (xb, st["feature"], st["threshold"], st["value"],
            st["tree_class"], C, forest.learning_rate)
    t0 = time.perf_counter()
    margins = native.gbdt_predict_margins(*args)
    margins_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(margins, native.gbdt_predict_margins(
            *args, plain=True)):
        raise AssertionError("gbdt: the core's margins differ from the "
                             "plain version's")
    # an AL member: its fit, one update on a 10-song batch, a pool predict
    xf, yf = labelled_rows(np.random.default_rng(SEED + 9), centers,
                           GBDT_FIT_ROWS)
    t0 = time.perf_counter()
    member = NativeGBDTMember("xgb.it_0").fit(xf, yf)
    fit_s = time.perf_counter() - t0
    xq, yq = labelled_rows(np.random.default_rng(SEED + 10), centers,
                           Q * USER_FRAMES)
    n_fit_trees = member.model.n_trees
    t0 = time.perf_counter()
    member.update(xq, yq)
    update_s = time.perf_counter() - t0
    xp, _ = labelled_rows(np.random.default_rng(SEED + 11), centers,
                          USER_SONGS * USER_FRAMES)
    t0 = time.perf_counter()
    p = member.predict_proba(xp)
    predict_ms = (time.perf_counter() - t0) * 1e3
    if not (np.all(np.isfinite(p)) and np.allclose(p.sum(1), 1, atol=1e-5)):
        raise AssertionError("gbdt: pool probabilities are not rows of a "
                             "distribution")
    print(f"[gbdt] host core {os.path.basename(lib)} built in {build_s:.3f} "
          f"s; DEAM scale ({DEAM_SONGS} songs x {DEAM_FRAMES} frames = {n} "
          f"rows, F={F}, {GBDT_BINS} bins, depth {GBDT_DEPTH}): binning "
          f"{bin_s:.3f} s, one tree {tree_ms:.3f} ms (plain "
          f"{plain_ms:.3f} ms), bit-equal; margins of {forest.n_trees} "
          f"trees {margins_ms:.3f} ms, bit-equal to the plain version")
    print(f"[gbdt] {card}: host clock, an AL member (100 rounds x {C} "
          f"classes, depth {GBDT_DEPTH}): fit on {GBDT_FIT_ROWS} rows "
          f"{fit_s:.3f} s, update on a {Q}-song batch ({Q * USER_FRAMES} "
          f"rows, +{member.model.n_trees - n_fit_trees} trees) "
          f"{update_s:.3f} s, "
          f"pool predict of {len(xp)} rows with {member.model.n_trees} "
          f"trees {predict_ms:.3f} ms")
    return {"fit_s": fit_s, "update_s": update_s, "predict_ms": predict_ms}


def cnn_work(cfg, n_crops=1):
    """FLOP and bytes of one forward of ``cfg``'s trunk over ``n_crops``
    crops: the frontend's DFT and mel (or harmonic) matmuls, the
    convolutions and dense layers (2 per multiply-add), about 6
    elementwise operations per convolution output (BatchNorm, ReLU,
    pooling, the residual sum); bytes are the crops read once, the weights
    read once and the scores written once."""
    t, nf = cfg.n_frames, cfg.n_fft // 2 + 1
    dft = 2 * t * cfg.n_fft * nf * 2

    def conv(taps, c_in, c_out, n_out):
        return (2 * taps * c_in + 6) * c_out * n_out

    widths = cfg.channel_widths
    if cfg.arch == "se1d":
        n = (cfg.input_length - 3) // 3 + 1
        flop = conv(3, 1, widths[0], n)
        c_in = widths[0]
        for w in widths:
            flop += conv(3, c_in, w, n) + conv(3, w, w, n) + 4 * w * w
            if c_in != w:
                flop += conv(3, c_in, w, n)
            c_in, n = w, n // 3
    elif cfg.arch == "musicnn":
        flop = dft + 2 * cfg.n_mels * nf * t
        c = cfg.n_channels
        for frac in short_cnn.MUSICNN_V_FRACS:
            h = max(1, int(cfg.n_mels * frac))
            flop += conv(h * short_cnn.MUSICNN_V_WIDTH, 1, c,
                         (cfg.n_mels - h + 1) * t)
        for length in short_cnn.MUSICNN_H_LENGTHS:
            flop += conv(length, 1, c, t)
        c_in, n = c * (len(short_cnn.MUSICNN_V_FRACS)
                       + len(short_cnn.MUSICNN_H_LENGTHS)), t
        for w in widths:
            flop += conv(3, c_in, w, n)
            c_in, n = w, n // 2
    else:
        if cfg.arch == "harm":
            h, c_in = cfg.harm_level, cfg.n_harmonic
            flop = dft + 2 * cfg.n_harmonic * h * nf * t
        else:
            h, c_in = cfg.n_mels, 1
            flop = dft + 2 * cfg.n_mels * nf * t
        w_ = t
        for width in widths:
            if cfg.arch == "res":
                h, w_ = -(-h // 2), -(-w_ // 2)
                flop += 2 * conv(9, c_in, width, h * w_) + conv(
                    9, width, width, h * w_)
            else:
                flop += conv(9, c_in, width, h * w_)
                h, w_ = h // 2, w_ // 2
            c_in = width
    d = widths[-1]
    flop += 2 * d * d + 2 * d * cfg.n_class
    n_weights = sum(int(np.prod(s)) for s in
                    short_cnn.variable_shapes(cfg).values())
    n_bytes = 4 * (n_crops * cfg.input_length + n_weights
                   + n_crops * cfg.n_class)
    return n_crops * flop, n_bytes


def make_waves(n_songs, n_samples, seed):
    """Seeded noise clips (std 0.1), one per song."""
    rng = np.random.default_rng(seed)
    return {i: rng.standard_normal(n_samples, np.float32) * np.float32(0.1)
            for i in range(n_songs)}


def train_step_grads(variables, x, y, dropout_key, cfg):
    """The loss and the flat gradient of one training step's forward and
    backward (``CNNTrainer._epoch``'s step without the optimizer), the
    parameters in name order, float64 on the CPU."""
    params = {k: t.detach().clone().requires_grad_(True)
              for k, t in variables.items() if not short_cnn.is_stat(k)}
    stats = {k: t for k, t in variables.items() if short_cnn.is_stat(k)}
    out, _ = short_cnn.apply_train({**params, **stats}, x, dropout_key, cfg)
    loss = bce_loss(out, y)
    with short_cnn.exact_float32():
        loss.backward()
    return float(loss.detach()), torch.cat(
        [params[k].grad.reshape(-1).double().cpu() for k in sorted(params)])


def phase_cnn(card):
    """The vgg CNN at full width on the card against the CPU port."""
    cfg, tc = CNNConfig(), TrainConfig()
    waves = make_waves(CNN_CROPS, CLIP_SAMPLES, SEED + 12)
    stores = {d: DeviceWaveformStore(waves, cfg.input_length, d)
              for d in ("cuda", "cpu")}
    ids = list(waves)
    members = [CNNMember(f"cnn.it_{i}", short_cnn.init_variables(
        prng.key(SEED + i, "cpu"), cfg, "cuda"), cfg)
        for i in range(CNN_MEMBERS)]
    committee = Committee([], members, cfg, tc, device="cuda")
    cpu_vars = [{k: v.cpu() for k, v in m.variables.items()}
                for m in members[:CNN_CHECK_MEMBERS]]
    key = prng.key(SEED + 13, "cpu")
    rows = stores["cuda"].row_of(ids)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    probs = committee.predict_songs_cnn(stores["cuda"], ids, key)
    torch.cuda.synchronize()
    peak_fwd = torch.cuda.max_memory_allocated()
    p = probs.cpu().numpy()
    if p.shape != (CNN_MEMBERS, CNN_CROPS, C) or not (
            np.all(np.isfinite(p)) and p.min() > 0 and p.max() < 1):
        raise AssertionError(f"cnn: forward scores {p.shape} out of (0, 1)")
    fwd_ms = time_ms(lambda: committee.predict_songs_cnn(
        stores["cuda"], ids, key), reps=CNN_REPS)
    per_crop_ms = fwd_ms / (CNN_MEMBERS * CNN_CROPS)
    flop, n_bytes = cnn_work(cfg, CNN_CROPS)
    bound_ms = max(flop / PEAK_F32_FLOP_S, n_bytes / PEAK_BYTES_S) * 1e3 \
        / CNN_CROPS
    # the same crops on both devices: the draws are the key's
    crops = {d: committee._bucketed_crops(stores[d], rows, key)
             for d in ("cuda", "cpu")}
    if not torch.equal(crops["cuda"].cpu(), crops["cpu"]):
        raise AssertionError("cnn: card and CPU crops differ")
    sub = {d: c[:CNN_CHECK_CROPS] for d, c in crops.items()}
    mel = log_mel_spectrogram(sub["cuda"], cfg).double().cpu()
    mel_ref = log_mel_spectrogram(sub["cpu"].double(), cfg)
    mel_err = float((mel - mel_ref).abs().max())
    np.testing.assert_allclose(mel.numpy(), mel_ref.numpy(), **MEL_TOL,
                               err_msg="cnn: log-mel vs float64")
    ref = short_cnn.committee_infer(cpu_vars, sub["cpu"], cfg).numpy()
    got = p[:CNN_CHECK_MEMBERS, :CNN_CHECK_CROPS]
    prob_err = float(np.abs(got - ref).max())
    np.testing.assert_allclose(got, ref, **CNN_TOL,
                               err_msg="cnn: card vs CPU probabilities")
    # qbdc: one member under QBDC_K masks
    q_crops, mask_keys = committee._qbdc_stage(stores["cuda"], rows, key,
                                               QBDC_K)
    q_ref_crops = committee._bucketed_crops(stores["cpu"], rows,
                                            prng.split(key)[0])
    if not torch.equal(q_crops.cpu(), q_ref_crops):
        raise AssertionError("cnn: qbdc crops differ between card and CPU")
    d_feat = cfg.channel_widths[-1]
    keep = 1.0 - cfg.dropout_rate
    for k in mask_keys:
        if not torch.equal(prng.bernoulli(k, keep, (d_feat,),
                                          device="cuda").cpu(),
                           prng.bernoulli(k, keep, (d_feat,), device="cpu")):
            raise AssertionError("cnn: qbdc masks differ")
    with torch.no_grad():
        q_got = short_cnn.qbdc_infer(members[0].variables,
                                     q_crops[:CNN_CHECK_CROPS], mask_keys,
                                     cfg).cpu().numpy()
    q_ref = short_cnn.qbdc_infer(cpu_vars[0], q_ref_crops[:CNN_CHECK_CROPS],
                                 mask_keys, cfg).numpy()
    qbdc_err = float(np.abs(q_got - q_ref).max())
    np.testing.assert_allclose(q_got, q_ref, **CNN_TOL,
                               err_msg="cnn: qbdc card vs CPU")
    qbdc_ms = time_ms(lambda: committee.qbdc_pool_probs(
        stores["cuda"], ids, key, k=QBDC_K), reps=CNN_REPS)
    # fit_many: FIT_EPOCHS epochs on FIT_SONGS songs, validated on
    # FIT_TEST_SONGS, card (every member) against CPU (the first two)
    labels = np.random.default_rng(SEED + 14).integers(0, C, CNN_CROPS)
    tr, te = ids[:FIT_SONGS], ids[FIT_SONGS:FIT_SONGS + FIT_TEST_SONGS]
    y_tr, y_te = one_hot_np(labels[tr]), one_hot_np(labels[te])
    fkey = prng.key(SEED + 15, "cpu")
    trainers = {d: CNNTrainer(cfg, tc) for d in ("cuda", "cpu")}
    # one warm-up epoch: the timed fit should not carry cuDNN's first calls
    trainers["cuda"].fit(members[0].variables, stores["cuda"], tr, y_tr, te,
                         y_te, fkey, n_epochs=1)
    for t in trainers.values():
        t.draws = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, hist = trainers["cuda"].fit_many(
        [m.variables for m in members], stores["cuda"], tr, y_tr, te, y_te,
        fkey, n_epochs=FIT_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak_fit = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    _, hist_ref = trainers["cpu"].fit_many(
        cpu_vars, stores["cpu"], tr, y_tr, te, y_te, fkey,
        n_epochs=FIT_EPOCHS)
    cpu_fit_s = time.perf_counter() - t0
    n_draws = CNN_CHECK_MEMBERS * FIT_EPOCHS
    for a, b in zip(trainers["cuda"].draws[:n_draws],
                    trainers["cpu"].draws):
        for k in ("perm", "starts", "test_starts"):
            if not torch.equal(a[k], b[k]):
                raise AssertionError(f"cnn fit: card and CPU {k} differ")
        for dk in b["dropout_keys"]:
            shape = (tc.batch_size, d_feat)
            if not torch.equal(
                    prng.bernoulli(prng.fold_in_static(
                        dk, *short_cnn.DROPOUT_RNG_PATH), keep, shape,
                        device="cuda").cpu(),
                    prng.bernoulli(prng.fold_in_static(
                        dk, *short_cnn.DROPOUT_RNG_PATH), keep, shape,
                        device="cpu")):
                raise AssertionError("cnn fit: dropout masks differ")
    loss_err = 0.0
    for m, (h, r) in enumerate(zip(hist, hist_ref)):
        print(f"[cnn] fit member {m} (card / CPU) " + "; ".join(
            f"epoch {e['epoch']} {e['phase']} train {e['train_loss']:.6f} / "
            f"{er['train_loss']:.6f} val {e['val_loss']:.6f} / "
            f"{er['val_loss']:.6f}" for e, er in zip(h, r)))
        for e, er in zip(h, r):
            for k in ("train_loss", "val_loss"):
                loss_err = max(loss_err, abs(e[k] - er[k]))
                np.testing.assert_allclose(e[k], er[k], **FIT_TOL,
                                           err_msg=f"cnn fit {k}")
    # one step's gradient at the members' initial weights, card vs CPU,
    # in float32 and in float64
    step_x = {d: crops[d][:tc.batch_size] for d in crops}
    step_y = torch.from_numpy(one_hot_np(labels[:tc.batch_size]))
    dk = prng.key(SEED + 16, "cpu")
    grad_err = {}
    for dtype in ("float32", "float64"):
        cfg_d = dataclasses.replace(cfg, compute_dtype=dtype)
        d = getattr(torch, dtype)
        loss_c, g_c = train_step_grads(
            {k: t.to(d) for k, t in members[0].variables.items()},
            step_x["cuda"].to(d), step_y.to(step_x["cuda"].device, d), dk,
            cfg_d)
        loss_h, g_h = train_step_grads(
            {k: t.to(d) for k, t in cpu_vars[0].items()},
            step_x["cpu"].to(d), step_y.to(d), dk, cfg_d)
        grad_err[dtype] = float((g_c - g_h).norm() / g_h.norm())
        if abs(loss_c - loss_h) > 1e-5:
            raise AssertionError(f"cnn: a training step's {dtype} loss "
                                 f"{loss_c} (card) / {loss_h} (CPU)")
    if (grad_err["float64"] > GRAD64_REL_TOL
            or grad_err["float32"] > GRAD32_REL_TOL):
        raise AssertionError(f"cnn: a training step's gradient, card vs "
                             f"CPU, relative L2 error {grad_err}")
    epoch_ms = fit_s * 1e3 / (CNN_MEMBERS * FIT_EPOCHS)
    f_fwd, _ = cnn_work(cfg)
    epoch_flop = f_fwd * (3 * FIT_SONGS + FIT_TEST_SONGS)
    epoch_bound = epoch_flop / PEAK_F32_FLOP_S * 1e3
    print(f"[cnn] vgg at full width ({cfg.n_channels} channels, "
          f"{cfg.n_layers} layers, {cfg.n_mels} mels, {cfg.input_length}-"
          f"sample crops of {CLIP_SAMPLES}-sample clips), {CNN_MEMBERS} "
          f"members x {CNN_CROPS} crops on the card; {CNN_CHECK_MEMBERS} "
          f"members x {CNN_CHECK_CROPS} crops against the CPU port: crops "
          f"equal, log-mel vs float64 max |err| {mel_err:.3e} dB, "
          f"probabilities max |err| {prob_err:.3e} ({CNN_TOL}); qbdc "
          f"K={QBDC_K}: crops and masks equal, max |err| {qbdc_err:.3e}; "
          f"fit_many {FIT_EPOCHS} epochs on {FIT_SONGS} songs (validated "
          f"on {FIT_TEST_SONGS}): permutations, crop starts and dropout "
          f"masks equal, losses max |err| {loss_err:.3e} ({FIT_TOL}); one "
          f"step's gradient, card vs CPU, relative L2 error: float64 "
          f"{grad_err['float64']:.3e} (<= {GRAD64_REL_TOL}), float32 "
          f"{grad_err['float32']:.3e} (<= {GRAD32_REL_TOL}); "
          f"CPU fit {cpu_fit_s:.1f} s")
    print(f"[cnn] {card}: forward {per_crop_ms:.5f} ms per crop per member "
          f"(CUDA events, median of {CNN_REPS} passes of {CNN_MEMBERS} x "
          f"{CNN_CROPS}), FLOP bound {bound_ms:.5f} ms ({flop / CNN_CROPS:.4e}"
          f" FLOP a crop at {PEAK_F32_FLOP_S:.3g} FLOP/s float32, "
          f"{bound_ms / per_crop_ms:.1%}); qbdc K={QBDC_K} pass over "
          f"{CNN_CROPS} crops {qbdc_ms:.3f} ms; retrain {epoch_ms:.3f} ms "
          f"per member-epoch ({FIT_SONGS} train + {FIT_TEST_SONGS} "
          f"validation crops, host clock over {CNN_MEMBERS} x {FIT_EPOCHS}; "
          f"FLOP bound {epoch_bound:.3f} ms); peak device memory "
          f"{peak_fwd / 2**30:.2f} GiB forward, {peak_fit / 2**30:.2f} GiB "
          f"retrain")
    return {"per_crop_ms": per_crop_ms, "epoch_ms": epoch_ms}


def full_user(store_ids, seed=SEED + 16, n_songs=USER_SONGS):
    """One AMG1608 user: ``n_songs`` annotated songs (a seeded choice of
    the store's ids) with USER_FRAMES frames of F features around seeded
    class centres, and seeded labels."""
    rng = np.random.default_rng(seed)
    songs = sorted(rng.choice(store_ids, n_songs, replace=False).tolist())
    labels = {s: int(c) for s, c in zip(songs, rng.integers(0, C,
                                                             n_songs))}
    centers = rng.normal(0, CENTER_SD * 5, (C, F)).astype(np.float32)
    frames = (rng.standard_normal((n_songs, USER_FRAMES, F), np.float32)
              + centers[[labels[s] for s in songs]][:, None, :])
    pool = FramePool(frames.reshape(-1, F), np.repeat(songs, USER_FRAMES))
    return pool, labels, centers


def full_host_members(centers, seed):
    """FULL_MEMBERS GaussianNB, SGD and GBDT members, each fitted by the
    port on its own seeded labelled draw."""
    members = fit_members(centers, FULL_MEMBERS, seed)
    for i in range(FULL_MEMBERS):
        x, y = labelled_rows(np.random.default_rng(seed + 200 + i), centers,
                             GBDT_FIT_ROWS)
        members.append(NativeGBDTMember(f"xgb.it_{i}").fit(x, y))
    return members


def full_cnn_members(cfg, store, pre_ids, seed, device, fit=True):
    """FULL_MEMBERS vgg members from ``init_variables``, then (``fit``) a
    short fit on seeded labels of ``pre_ids``' waveforms."""
    variables = [short_cnn.init_variables(prng.key(seed + i, "cpu"), cfg,
                                          device)
                 for i in range(FULL_MEMBERS)]
    if fit:
        y = one_hot_np(np.random.default_rng(seed).integers(
            0, C, len(pre_ids)))
        n = len(pre_ids) // 2
        variables, _ = CNNTrainer(cfg, TrainConfig()).fit_many(
            variables, store, pre_ids[:n], y[:n], pre_ids[n:], y[n:],
            prng.key(seed, "cpu"), n_epochs=PRE_FIT_EPOCHS)
    return [CNNMember(f"cnn.it_{i}", v, cfg)
            for i, v in enumerate(variables)]


def amg_user_on_card():
    """AMG1608's FULL_SONGS seeded 30-s clips in a store on the card and
    one user of USER_SONGS annotated songs (phases 14 and 15)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    t0 = time.perf_counter()
    data_t = torch.randn((FULL_SONGS, CLIP_SAMPLES), generator=gen,
                         device="cuda").mul_(0.1)
    ids = list(range(1, FULL_SONGS + 1))
    store = DeviceWaveformStore.from_padded(
        ids, data_t, torch.full((FULL_SONGS,), CLIP_SAMPLES, device="cuda"),
        CNNConfig().input_length)
    torch.cuda.synchronize()
    store_s = time.perf_counter() - t0
    pool, labels, centers = full_user(ids)
    return {"data_t": data_t, "ids": ids, "store": store, "store_s": store_s,
            "pool": pool, "labels": labels, "centers": centers}


def phase_al_loop_full(card, user):
    """The paper's committee (5 GaussianNB, 5 SGD, 5 GBDT, 5 vgg CNN) in
    one AMG1608 user's AL loop on the card, mc and qbdc; iteration 0 at a
    narrow CNN width against the CPU.  Returns the host members."""
    cfg = CNNConfig()
    data_t, ids, store, store_s = (user["data_t"], user["ids"],
                                   user["store"], user["store_s"])
    pool, labels, centers = user["pool"], user["labels"], user["centers"]
    pre_ids = [i for i in ids if i not in labels][:PRE_FIT_SONGS]
    t0 = time.perf_counter()
    host = full_host_members(centers, SEED + 18)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cnns = full_cnn_members(cfg, store, pre_ids, SEED + 19, "cuda")
    torch.cuda.synchronize()
    cnn_s = time.perf_counter() - t0
    data = UserData("amg-user", pool, labels, store=store)
    n_train = int(round(TRAIN_SIZE * USER_SONGS))
    n_members = 4 * FULL_MEMBERS
    stats, busy, picks0 = {}, None, {}
    with tempfile.TemporaryDirectory() as root:
        for mode, epochs in FULL_EPOCHS.items():
            linear_mc.launches = 0
            committee = Committee(copy.deepcopy(host), copy.deepcopy(cnns),
                                  cfg, device="cuda")
            timer = IterTimer(FULL_PROFILED_EPOCH
                              if mode == FULL_PROFILED_MODE else None)
            path = os.path.join(root, mode)
            picks, res = run_al_user(mode, committee, data, path, "cuda",
                                       epochs, timer, FULL_RETRAIN_EPOCHS)
            if linear_mc.launches:
                raise AssertionError(f"al-loop-full {mode}: linear_mc "
                                     "launched on a path without it")
            recs = check_al_run(mode, path, data, n_train, epochs,
                                n_members, what="al-loop-full")
            if len(picks) != epochs:
                raise AssertionError(f"al-loop-full {mode}: {len(picks)} "
                                     "selects")
            iters = [r for r in timer.records
                     if r["epoch"] >= 0 and r["epoch"] != timer.profile_epoch]
            # a mode whose only iteration is traced reports that one
            over = f"{len(iters)} untraced" if iters else "1 traced"
            iters = iters or [r for r in timer.records if r["epoch"] >= 0]
            stats[mode] = {k: statistics.median(r.get(f"{k}_s", 0.0)
                                                for r in iters) * 1e3
                           for k in FULL_PHASES + ("iteration",)}
            stats[mode]["final_f1"] = recs[epochs - 1]["mean_f1"]
            stats[mode]["over"] = over
            if mode == FULL_PROFILED_MODE:
                busy = timer.busy
            del committee
            torch.cuda.empty_cache()
        # iteration 0 at a narrow CNN width, card against CPU
        narrow = CNNConfig(**NARROW_CNN)
        user_rows = store.row_of(pool.song_ids)
        cpu_store = DeviceWaveformStore.from_padded(
            pool.song_ids, data_t[torch.as_tensor(user_rows,
                                                  device="cuda")].cpu(),
            torch.full((USER_SONGS,), CLIP_SAMPLES), narrow.input_length)
        narrow_store = DeviceWaveformStore.from_padded(
            ids, data_t, store.lengths, narrow.input_length)
        narrow_cnns = full_cnn_members(narrow, None, None, SEED + 20, "cpu",
                                       fit=False)
        near, narrow_s = {}, {}
        for mode in FULL_EPOCHS:
            for side, (dev, st) in enumerate((("cuda", narrow_store),
                                              ("cpu", cpu_store))):
                committee = Committee(copy.deepcopy(host),
                                      copy.deepcopy(narrow_cnns), narrow,
                                      device=dev)
                t0 = time.perf_counter()
                picks0[side], _ = run_al_user(
                    mode, committee, UserData("amg-user", pool, labels,
                                              store=st),
                    os.path.join(root, f"narrow-{mode}-{side}"), dev,
                    NARROW_EPOCHS, StepTimer(None), NARROW_RETRAIN_EPOCHS)
                narrow_s[f"{mode} {dev}"] = time.perf_counter() - t0
            near[mode] = _compare_slots(
                picks0[0][0], picks0[1][0],
                f"al-loop-full {mode} iteration 0, card vs CPU", **CNN_TOL)
    del narrow_store
    torch.cuda.empty_cache()
    print(f"[al-loop-full] {FULL_MEMBERS} GaussianNB + {FULL_MEMBERS} SGD + "
          f"{FULL_MEMBERS} GBDT + {FULL_MEMBERS} vgg CNN members (host fits "
          f"{host_s:.1f} s, CNN init + {PRE_FIT_EPOCHS}-epoch fit on "
          f"{PRE_FIT_SONGS} songs {cnn_s:.1f} s); a store of {FULL_SONGS} "
          f"clips x {CLIP_SAMPLES} samples on the card "
          f"({FULL_SONGS * CLIP_SAMPLES * 4 / 1e9:.2f} GB, {store_s:.1f} s);"
          f" one user with {USER_SONGS} songs x {USER_FRAMES} frames, q={Q},"
          f" {FULL_RETRAIN_EPOCHS} retrain epochs an iteration, "
          f"iterations {FULL_EPOCHS} (qbdc K={QBDC_K}): queried songs "
          f"disjoint, pool shrinking by q, F1s finite, each state at "
          f"next_epoch = its iterations; kernel launches 0")
    print(f"[al-loop-full] iteration 0 card vs CPU at a narrow CNN "
          f"({NARROW_CNN}, {NARROW_EPOCHS} iteration of "
          f"{NARROW_RETRAIN_EPOCHS} retrain epochs): slot values within "
          f"{CNN_TOL}, slots naming another song {near}; wall s " +
          ", ".join(f"{k} {v:.1f}" for k, v in narrow_s.items()))
    for mode, st in stats.items():
        print(f"[al-loop-full] {card}: {mode} median ms per iteration "
              f"(StepTimer, host clock, over {st['over']}): "
              + ", ".join(
                  f"{k} {st[k]:.3f}" for k in FULL_PHASES + ("iteration",))
              + f"; final mean F1 {st['final_f1']:.4f}")
    print(f"[al-loop-full] {card}: device busy over {FULL_PROFILED_MODE} "
          f"iteration {FULL_PROFILED_EPOCH} (torch.profiler, device events "
          "only): " + (
              "not measured (no device events)" if busy is None else
              f"{busy[0]:.2%} of the iteration, {busy[1]:.3f} ms"))
    return host


def write_npy_tree(amg_root, seed=SEED + 21):
    """``npy/{song_id}.npy``: a seeded CLI_CLIP_SAMPLES-sample clip for
    each of the tree's songs."""
    npy = os.path.join(amg_root, "npy")
    os.makedirs(npy)
    rng = np.random.default_rng(seed)
    for sid in range(1, AMG_SONGS + 1):
        np.save(os.path.join(npy, f"{sid}.npy"),
                rng.standard_normal(CLI_CLIP_SAMPLES, np.float32)
                * np.float32(0.1))


def write_cnn_registry(src_models, models_root, seed=SEED + 22,
                       arch="vgg"):
    """The host registry of ``src_models`` plus CLI_XGB GBDT members and
    CLI_CNN_MEMBERS ``arch`` members at the CLI's narrow geometry."""
    pre = os.path.join(models_root, "pretrained")
    shutil.copytree(os.path.join(src_models, "pretrained"), pre)
    centers = np.random.default_rng(seed).normal(0, 0.5, (C, F)).astype(
        np.float32)
    for i in range(CLI_XGB):
        x, y = labelled_rows(np.random.default_rng(seed + i), centers,
                             GBDT_FIT_ROWS)
        m = NativeGBDTMember(f"xgb.it_{i}").fit(x, y)
        m.save(os.path.join(pre, Committee.member_file(m)))
    cfg = CNNConfig(arch=arch, **CLI_CNN)
    for i in range(CLI_CNN_MEMBERS):
        m = CNNMember(f"cnn.it_{i}", short_cnn.init_variables(
            prng.key(seed + 10 + i, "cpu"), cfg, "cpu"), cfg)
        m.save(os.path.join(pre, Committee.member_file(m)))


def phase_al_cli_cnn(card, root, amg_root, host_models):
    """The CLI with xgb and CNN members in the registry, mc and qbdc, on
    the card and on the CPU, then mc with res members scoring full songs
    (CLI_FULL_SONG); iteration 0's selection card against CPU (slot values
    within CNN_TOL, near-ties counted)."""
    t0 = time.perf_counter()
    write_npy_tree(amg_root)
    npy_s = time.perf_counter() - t0
    bases = {arch: os.path.join(root, f"models_cnn_{arch}")
             for arch in ("vgg", CLI_FULL_SONG["arch"])}
    for arch, base in bases.items():
        write_cnn_registry(host_models, base, arch=arch)
    near, walls, paths = {}, {}, {}
    n_members = 2 * REG_MEMBERS + CLI_XGB + CLI_CNN_MEMBERS
    runs = {"mc": ("vgg", []), "qbdc": ("vgg", []),
            "mc-full-song": (CLI_FULL_SONG["arch"], [
                "--cnn-arch", CLI_FULL_SONG["arch"], "--full-song-hop",
                str(CLI_FULL_SONG["hop"])])}
    for run, (arch, extra) in runs.items():
        mode = run.split("-")[0]
        picks = {}
        for d, epochs in (("cuda", CLI_CNN_EPOCHS),
                          ("cpu", CLI_CNN_CPU_EPOCHS)):
            models = os.path.join(root, f"models_cnn_{run}_{d}")
            shutil.copytree(os.path.join(bases[arch], "pretrained"),
                            os.path.join(models, "pretrained"))
            linear_mc.launches = 0
            t0 = time.perf_counter()
            with recorded_scoring() as picks[d]:
                run_cli(with_epochs(CLI_CNN_ARGS, epochs) + [
                    "-m", mode, "--models-root", models, "--amg-root",
                    amg_root, "--device", d, "--cnn-config-json",
                    json.dumps(CLI_CNN)] + extra)
            walls[f"{run} {d}"] = time.perf_counter() - t0
            if linear_mc.launches:
                raise AssertionError(f"al-cli {run} {d}: linear_mc launched "
                                     "on a path without it")
            if len(picks[d]) != epochs:
                raise AssertionError(f"al-cli {run} {d}: "
                                     f"{len(picks[d])} selects")
            users = os.path.join(models, "users")
            (uid,) = os.listdir(users)
            path = paths[(run, d)] = os.path.join(users, uid, mode)
            recs = read_metrics(path)
            st = al_state.ALState.load(path)
            if (sorted(recs) != list(range(-1, epochs))
                    or st.next_epoch != epochs
                    or not os.path.exists(os.path.join(path, "DONE"))):
                raise AssertionError(f"al-cli {run} {d}: epochs "
                                     f"{sorted(recs)}, state {st.next_epoch}")
            for e, r in recs.items():
                if (len(r["f1"]) != n_members
                        or not np.all(np.isfinite(r["f1"]))):
                    raise AssertionError(f"al-cli {run} {d} epoch {e}: "
                                         f"F1s {r['f1']}")
            files = sorted(os.listdir(path))
            if sum(f.startswith("classifier_") for f in files) != n_members:
                raise AssertionError(f"al-cli {run} {d}: members {files}")
            cnn_file = os.path.join(path, "classifier_"
                                    f"{CNNMember.file_stem(arch)}.cnn.it_0.npz")
            if CNNMember.load(cnn_file, CNNConfig(**CLI_CNN),
                              device="cpu").config.arch != arch:
                raise AssertionError(f"al-cli {run} {d}: not {arch} members")
        near[run] = _compare_slots(
            picks["cuda"][0], picks["cpu"][0],
            f"al-cli {run} iteration 0, card vs CPU", **CNN_TOL)
    n_windows = ((CLI_CLIP_SAMPLES - CLI_CNN["input_length"])
                 // CLI_FULL_SONG["hop"] + 1)
    print(f"[al-cli] {card}: amg_test {' '.join(CLI_CNN_ARGS)} (on the "
          f"CPU -e {CLI_CNN_CPU_EPOCHS}) -m mc|qbdc "
          f"with {CLI_XGB} GBDT and {CLI_CNN_MEMBERS} vgg members ("
          f"{CLI_CNN}) added to the registry, and -m mc with "
          f"{CLI_FULL_SONG['arch']} members and --full-song-hop "
          f"{CLI_FULL_SONG['hop']} ({n_windows} windows a song), waveforms "
          f"from npy/ ({AMG_SONGS} clips of {CLI_CLIP_SAMPLES} samples, "
          f"written in {npy_s:.1f} s): every "
          f"epoch on the card and on the CPU, {n_members} finite F1s, state "
          f"and DONE written, linear_mc launches 0; iteration 0 card vs CPU:"
          f" slot values within {CNN_TOL}, slots naming another song {near};"
          f" wall s " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return {"bases": bases, "paths": paths}


# -- slice 6: the other trunk families and full-song scoring ---------------


def param_slice(variables, name):
    """Where ``name`` sits in ``train_step_grads``' flat gradient."""
    lo = 0
    for k in sorted(k for k in variables if not short_cnn.is_stat(k)):
        n = variables[k].numel()
        if k == name:
            return slice(lo, lo + n)
        lo += n
    raise KeyError(name)


def trunk_at_full_width(card, arch, stores, ids, labels, seed):
    """One trunk family at full width on the card against the CPU port,
    as phase 13 holds vgg."""
    cfg, tc = CNNConfig(arch=arch), TrainConfig()
    members = [CNNMember(f"{arch}.it_{i}", short_cnn.init_variables(
        prng.key(seed + i, "cpu"), cfg, "cuda"), cfg)
        for i in range(CNN_MEMBERS)]
    committee = Committee([], members, cfg, tc, device="cuda")
    cpu_vars = [short_cnn.init_variables(prng.key(seed + i, "cpu"), cfg,
                                         "cpu")
                for i in range(CNN_CHECK_MEMBERS)]
    # the initializer's draws (Flax's, C12) are the same on both devices
    n_diff = sum(int((members[i].variables[k].cpu() != v[k]).sum())
                 for i, v in enumerate(cpu_vars) for k in v)
    if n_diff:
        raise AssertionError(f"trunks {arch}: init_variables differs in "
                             f"{n_diff} entries between card and CPU")
    key = prng.key(seed, "cpu")
    rows = stores["cuda"].row_of(ids)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p = committee.predict_songs_cnn(stores["cuda"], ids, key).cpu().numpy()
    peak = torch.cuda.max_memory_allocated()
    if p.shape != (CNN_MEMBERS, CNN_CROPS, C) or not (
            np.all(np.isfinite(p)) and p.min() > 0 and p.max() < 1):
        raise AssertionError(f"trunks {arch}: forward scores {p.shape} out "
                             "of (0, 1)")
    fwd_ms = time_ms(lambda: committee.predict_songs_cnn(
        stores["cuda"], ids, key), reps=TRUNK_REPS)
    per_crop_ms = fwd_ms / (CNN_MEMBERS * CNN_CROPS)
    flop, n_bytes = cnn_work(cfg, CNN_CROPS)
    bound_ms = max(flop / PEAK_F32_FLOP_S, n_bytes / PEAK_BYTES_S) * 1e3 \
        / CNN_CROPS
    crops = {d: committee._bucketed_crops(stores[d], rows, key)
             for d in ("cuda", "cpu")}
    if not torch.equal(crops["cuda"].cpu(), crops["cpu"]):
        raise AssertionError(f"trunks {arch}: card and CPU crops differ")
    sub = {d: c[:CNN_CHECK_CROPS] for d, c in crops.items()}
    ref = short_cnn.committee_infer(cpu_vars, sub["cpu"], cfg).numpy()
    errs = {"scores": float(np.abs(p[:CNN_CHECK_MEMBERS, :CNN_CHECK_CROPS]
                                   - ref).max())}
    np.testing.assert_allclose(p[:CNN_CHECK_MEMBERS, :CNN_CHECK_CROPS], ref,
                               **CNN_TOL, err_msg=f"trunks {arch}: scores")
    with torch.no_grad():
        f_got = short_cnn.apply_features(members[0].variables, sub["cuda"],
                                         cfg).cpu().numpy()
    f_ref = short_cnn.apply_features(cpu_vars[0], sub["cpu"], cfg).numpy()
    errs["features"] = float(np.abs(f_got - f_ref).max())
    np.testing.assert_allclose(f_got, f_ref, **FEAT_TOL,
                               err_msg=f"trunks {arch}: features")
    q_crops, mask_keys = committee._qbdc_stage(stores["cuda"], rows, key,
                                               QBDC_K)
    q_ref_crops = committee._bucketed_crops(stores["cpu"], rows,
                                            prng.split(key)[0])
    if not torch.equal(q_crops.cpu(), q_ref_crops):
        raise AssertionError(f"trunks {arch}: qbdc crops differ")
    with torch.no_grad():
        q_got = short_cnn.qbdc_infer(members[0].variables,
                                     q_crops[:CNN_CHECK_CROPS], mask_keys,
                                     cfg).cpu().numpy()
    q_ref = short_cnn.qbdc_infer(cpu_vars[0], q_ref_crops[:CNN_CHECK_CROPS],
                                 mask_keys, cfg).numpy()
    errs["qbdc"] = float(np.abs(q_got - q_ref).max())
    np.testing.assert_allclose(q_got, q_ref, **CNN_TOL,
                               err_msg=f"trunks {arch}: qbdc")
    # one float64 training step's gradient, card against CPU
    cfg64 = dataclasses.replace(cfg, compute_dtype="float64")
    step_y = torch.from_numpy(one_hot_np(labels[:tc.batch_size])).double()
    dk = prng.key(seed + 1, "cpu")
    loss_c, g_c = train_step_grads(
        {k: t.double() for k, t in members[0].variables.items()},
        crops["cuda"][:tc.batch_size].double(), step_y.cuda(), dk, cfg64)
    loss_h, g_h = train_step_grads(
        {k: t.double() for k, t in cpu_vars[0].items()},
        crops["cpu"][:tc.batch_size].double(), step_y, dk, cfg64)
    errs["grad64"] = float((g_c - g_h).norm() / g_h.norm())
    if abs(loss_c - loss_h) > 1e-5 or errs["grad64"] > GRAD64_REL_TOL:
        raise AssertionError(f"trunks {arch}: a float64 training step, card"
                             f" vs CPU: losses {loss_c} / {loss_h}, "
                             f"gradient relative L2 {errs['grad64']}")
    if arch == "harm":
        at = param_slice(cpu_vars[0], "bw_q")
        bw_c, bw_h = float(g_c[at]), float(g_h[at])
        errs["bw_q_grad"] = abs(bw_c - bw_h) / abs(bw_h)
        if bw_h == 0 or errs["bw_q_grad"] > GRAD64_REL_TOL:
            raise AssertionError(f"trunks harm: bw_q's gradient {bw_c} "
                                 f"(card) / {bw_h} (CPU)")
    # fit_many, card (CNN_CHECK_MEMBERS) against CPU (the first)
    tr, te = ids[:FIT_SONGS], ids[FIT_SONGS:FIT_SONGS + FIT_TEST_SONGS]
    y_tr, y_te = one_hot_np(labels[tr]), one_hot_np(labels[te])
    fkey = prng.key(seed + 2, "cpu")
    trainers = {d: CNNTrainer(cfg, tc) for d in ("cuda", "cpu")}
    trainers["cuda"].fit(members[0].variables, stores["cuda"], tr, y_tr, te,
                         y_te, fkey, n_epochs=1)  # cuDNN's first calls
    for t in trainers.values():
        t.draws = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = trainers["cuda"].fit_many(
        [m.variables for m in members[:CNN_CHECK_MEMBERS]], stores["cuda"],
        tr, y_tr, te, y_te, fkey, n_epochs=TRUNK_FIT_EPOCHS)
    torch.cuda.synchronize()
    epoch_ms = (time.perf_counter() - t0) * 1e3 / (
        CNN_CHECK_MEMBERS * TRUNK_FIT_EPOCHS)
    _, hist_ref = trainers["cpu"].fit_many(
        cpu_vars[:1], stores["cpu"], tr, y_tr, te, y_te, fkey,
        n_epochs=TRUNK_FIT_EPOCHS)
    for a, b in zip(trainers["cuda"].draws, trainers["cpu"].draws):
        for k in ("perm", "starts", "test_starts", "dropout_keys"):
            if not torch.equal(a[k], b[k]):
                raise AssertionError(f"trunks {arch} fit: card and CPU {k} "
                                     "differ")
    errs["losses"] = 0.0
    for e, er in zip(hist[0], hist_ref[0]):
        for k in ("train_loss", "val_loss"):
            errs["losses"] = max(errs["losses"], abs(e[k] - er[k]))
            np.testing.assert_allclose(e[k], er[k], **FIT_TOL,
                                       err_msg=f"trunks {arch} fit {k}")
    f_fwd, _ = cnn_work(cfg)
    epoch_bound = (f_fwd * (3 * FIT_SONGS + FIT_TEST_SONGS)
                   / PEAK_F32_FLOP_S * 1e3)
    print(f"[trunks] {arch} at full width ({cfg.n_channels} channels, "
          f"{cfg.n_layers} layers, {cfg.input_length}-sample crops), "
          f"{CNN_MEMBERS} members x {CNN_CROPS} crops on the card; "
          f"{CNN_CHECK_MEMBERS} members x {CNN_CHECK_CROPS} crops against "
          f"the CPU port, initial variables, crops and qbdc masks equal, max "
          f"|err| " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items())
          + f" (scores and qbdc {CNN_TOL}, features {FEAT_TOL}, gradient "
          f"<= {GRAD64_REL_TOL}, losses {FIT_TOL})")
    print(f"[trunks] {card}: {arch} forward {per_crop_ms:.5f} ms per crop "
          f"per member (CUDA events, median of {TRUNK_REPS} passes of "
          f"{CNN_MEMBERS} x {CNN_CROPS}), FLOP bound {bound_ms:.5f} ms "
          f"({flop / CNN_CROPS:.4e} FLOP a crop at {PEAK_F32_FLOP_S:.3g} "
          f"FLOP/s float32, {bound_ms / per_crop_ms:.1%}); retrain "
          f"{epoch_ms:.3f} ms per member-epoch (host clock, FLOP bound "
          f"{epoch_bound:.3f} ms); peak device memory {peak / 2**30:.2f} GiB"
          " forward")
    return {"per_crop_ms": per_crop_ms, "bound_ms": bound_ms,
            "epoch_ms": epoch_ms, "peak_gib": peak / 2**30}


def full_song_scoring(card):
    """CNN_MEMBERS harm members scoring SONGS songs of mixed lengths on the
    window grid on the card; SONG_CHECK songs x CNN_CHECK_MEMBERS members
    against the CPU port."""
    cfg = CNNConfig(arch="harm")
    rng = np.random.default_rng(SEED + 40)
    lengths = rng.integers(SONG_SECONDS[0] * 16000,
                           SONG_SECONDS[1] * 16000 + 1, SONGS)
    waves = {i: rng.standard_normal(int(n), np.float32) * np.float32(0.1)
             for i, n in enumerate(lengths)}
    ids = list(waves)
    store = DeviceWaveformStore(waves, cfg.input_length, "cuda")
    members = [CNNMember(f"harm.it_{i}", short_cnn.init_variables(
        prng.key(SEED + 41 + i, "cpu"), cfg, "cuda"), cfg)
        for i in range(CNN_MEMBERS)]
    committee = Committee([], members, cfg, full_song_hop=SONG_HOP,
                          device="cuda")
    p = committee.predict_songs_cnn(store, ids, None).cpu().numpy()
    if p.shape != (CNN_MEMBERS, SONGS, C) or not (
            np.all(np.isfinite(p)) and p.min() > 0 and p.max() < 1):
        raise AssertionError(f"full-song: scores {p.shape} out of (0, 1)")
    ms = time_ms(lambda: committee.predict_songs_cnn(store, ids, None),
                 reps=TRUNK_REPS)
    _, valid = store.window_batch(store.row_of(ids), SONG_HOP)
    n_valid = valid.sum(dim=1).cpu()
    check = ids[:SONG_CHECK]
    cpu_store = DeviceWaveformStore({i: waves[i] for i in check},
                                    cfg.input_length, "cpu")
    cpu_com = Committee([], [CNNMember(m.name, {
        k: v.cpu() for k, v in m.variables.items()}, cfg)
        for m in members[:CNN_CHECK_MEMBERS]], cfg, full_song_hop=SONG_HOP,
        device="cpu")
    ref = cpu_com.predict_songs_cnn(cpu_store, check, None).numpy()
    got = p[:CNN_CHECK_MEMBERS, :SONG_CHECK]
    err = float(np.abs(got - ref).max())
    np.testing.assert_allclose(got, ref, **CNN_TOL,
                               err_msg="full-song: card vs CPU")
    windows = int(n_valid.sum())
    print(f"[full-song] {card}: {CNN_MEMBERS} harm members, "
          f"full_song_hop={SONG_HOP}, {SONGS} songs of "
          f"{SONG_SECONDS[0]}-{SONG_SECONDS[1]} s ({store.n_windows(SONG_HOP)}"
          f" windows a song on the grid, {int(n_valid.min())}-"
          f"{int(n_valid.max())} valid, {windows} in all): "
          f"{ms / SONGS:.3f} ms per song ({ms / windows / CNN_MEMBERS:.5f} ms"
          f" per valid window per member; CUDA events, median of "
          f"{TRUNK_REPS} passes); {SONG_CHECK} songs x {CNN_CHECK_MEMBERS} "
          f"members against the CPU port: max |err| {err:.3e} ({CNN_TOL})")
    return {"ms_per_song": ms / SONGS}


def harm_al_run(card, user, host):
    """Phase 14's user through ``ALLoop`` (mc) with 5 GaussianNB + 5 SGD
    members and HARM_MEMBERS full-width harm members scoring full songs."""
    cfg = CNNConfig(arch="harm")
    cnns = [CNNMember(f"cnn.it_{i}", short_cnn.init_variables(
        prng.key(SEED + 50 + i, "cpu"), cfg, "cuda"), cfg)
        for i in range(HARM_MEMBERS)]
    gnb_sgd = [m for m in host if isinstance(m, (GNBMember, SGDMember))]
    data = UserData("amg-user", user["pool"], user["labels"],
                    store=user["store"])
    n_train = int(round(TRAIN_SIZE * USER_SONGS))
    committee = Committee(copy.deepcopy(gnb_sgd), cnns, cfg,
                          full_song_hop=HARM_HOP, device="cuda")
    timer = IterTimer(None)
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "mc")
        picks, _ = run_al_user("mc", committee, data, path, "cuda",
                               HARM_EPOCHS, timer, HARM_RETRAIN)
        recs = check_al_run("mc", path, data, n_train, HARM_EPOCHS,
                            len(gnb_sgd) + HARM_MEMBERS, what="al-harm")
    if len(picks) != HARM_EPOCHS:
        raise AssertionError(f"al-harm: {len(picks)} selects")
    iters = [r for r in timer.records if r["epoch"] >= 0]
    st = {k: statistics.median(r.get(f"{k}_s", 0.0) for r in iters) * 1e3
          for k in FULL_PHASES + ("iteration",)}
    n_w = (CLIP_SAMPLES - cfg.input_length) // HARM_HOP + 1
    print(f"[al-harm] {card}: ALLoop mc, one AMG1608 user ({USER_SONGS} "
          f"songs of {CLIP_SAMPLES} samples, {FULL_SONGS} in the store on "
          f"the card), {len(gnb_sgd)} GaussianNB/SGD + {HARM_MEMBERS} harm "
          f"members scoring full songs (hop {HARM_HOP}, {n_w} windows a "
          f"song), {HARM_EPOCHS} iterations of q={Q} and {HARM_RETRAIN} "
          f"retrain epochs: queried songs disjoint, F1s finite, state "
          f"committed; median ms per iteration (StepTimer, host clock, over "
          f"{len(iters)}): " + ", ".join(
              f"{k} {st[k]:.3f}" for k in FULL_PHASES + ("iteration",))
          + f"; final mean F1 {recs[HARM_EPOCHS - 1]['mean_f1']:.4f}")
    return st


def phase_trunks(card, user, host):
    """Phase 15: res, harm, se1d and musicnn at full width against the CPU
    port; full-song scoring with harm members; the harm AL run.  None of
    it launches a hand kernel."""
    waves = make_waves(CNN_CROPS, CLIP_SAMPLES, SEED + 30)
    stores = {d: DeviceWaveformStore(waves, CNNConfig().input_length, d)
              for d in ("cuda", "cpu")}
    labels = np.random.default_rng(SEED + 31).integers(0, C, CNN_CROPS)
    linear_mc.launches = 0
    out = {arch: trunk_at_full_width(card, arch, stores, list(waves),
                                     labels, SEED + 32 + 10 * i)
           for i, arch in enumerate(TRUNK_ARCHS)}
    del stores
    torch.cuda.empty_cache()
    out["full-song"] = full_song_scoring(card)
    torch.cuda.empty_cache()
    out["al-harm"] = harm_al_run(card, user, host)
    if linear_mc.launches:
        raise AssertionError(f"trunks: {linear_mc.launches} linear_mc "
                             "launches on a path without the kernel")
    print(f"[trunks] linear_mc launches over phase 15: {linear_mc.launches}")
    return out


# -- slice 7: the fleet engine ---------------------------------------------

#: each fleet scorer key's per-user operands, by name (phase 16 (a))
FLEET_OPERANDS = {
    "mc": ("probs", "pool"), "mc_masked": ("probs", "pool", "members"),
    "hc": ("hc", "hc_mask"), "hc_pre": ("hc_ent", "hc_mask"),
    "mix": ("probs", "pool", "hc", "hc_mask"),
    "mix_masked": ("probs", "pool", "hc", "hc_mask", "members"),
    "rand": ("key", "pool"), "qbdc": ("probs", "pool"),
    "wmc": ("probs", "pool", "weights"),
    "wmc_masked": ("probs", "pool", "weights", "members"),
    "mc_fused": ("probs", "pool"), "qbdc_fused": ("probs", "pool"),
    "wmc_fused": ("probs", "pool", "weights"),
    "rand_fused": ("key", "pool"),
    "hc_pre_fused": ("hc_ent", "hc_mask", "pool"),
    "mix_fused": ("probs", "pool", "hc", "hc_mask"),
}


def fleet_operands():
    """FLEET_USERS users' operands on the card at configs[4] scale: an
    (M, N, C) probability table, pool and hc masks with MASKED_SHARE holes,
    an hc table and its entropies, reliability weights, a member mask
    (one member out) and a rand key."""
    rng = np.random.default_rng(SEED + 40)
    users = []
    for u in range(FLEET_USERS):
        p = rng.random((M, N, C), dtype=np.float32) + np.float32(0.01)
        p /= p.sum(-1, keepdims=True)
        pool = rng.random(N) >= MASKED_SHARE
        members = np.ones(M, bool)
        members[u] = False
        t = {name: torch.from_numpy(a).cuda() for name, a in (
            ("probs", p), ("pool", pool),
            ("hc", rng.random((N, C), dtype=np.float32)),
            ("hc_mask", pool & (rng.random(N) >= MASKED_SHARE)),
            ("weights", rng.uniform(0.2, 2.0, M).astype(np.float32)),
            ("members", members))}
        t["hc_ent"] = shannon_entropy(t["hc"])
        t["key"] = prng.key(SEED + 41 + u, "cpu")
        users.append(t)
    return users


def _single_scorers(k):
    """The single-user call of every fleet key (the ``*_masked`` keys are
    the scorers with their member mask)."""
    fns = make_scoring_fns(k=k)
    fns["mc_masked"] = lambda p, m, mm: scoring.score_mc(
        p, m, k=k, member_mask=mm)
    fns["mix_masked"] = lambda p, m, h, hm, mm: scoring.score_mix(
        p, m, h, hm, k=k, member_mask=mm)
    fns["wmc_masked"] = lambda p, m, w, mm: scoring.score_wmc(
        p, m, w, k=k, member_mask=mm)
    return fns


def _stack_operand(vals):
    if scoring.is_key_array(vals[0]):
        return scoring.stack_user_keys(vals)
    return torch.stack(vals)


def _compare_row(got, ref, i, what):
    """Row ``i`` of a stacked result against the single call: entropies and
    values within the gate (the same -inf rows), indices equal where values
    > -inf except near-ties, whose count is returned; the post-select masks
    equal when no slot names another row."""
    def host(x):
        return x.cpu().numpy()

    ge, re = host(got.entropy[i]), host(ref.entropy)
    if not np.array_equal(np.isneginf(ge), np.isneginf(re)):
        raise AssertionError(f"{what}: -inf rows differ")
    live = ~np.isneginf(re)
    np.testing.assert_allclose(ge[live], re[live], rtol=RTOL, atol=ATOL,
                               err_msg=what)
    gv, rv = host(got.values[i]), host(ref.values)
    valid = rv > -np.inf
    if not np.array_equal(gv > -np.inf, valid):
        raise AssertionError(f"{what}: valid slots differ")
    np.testing.assert_allclose(gv[valid], rv[valid], rtol=RTOL, atol=ATOL,
                               err_msg=what)
    near = int((valid & (host(got.indices[i]) != host(ref.indices))).sum())
    if not near and isinstance(ref, scoring.FusedStepResult):
        for field in ("pool_mask", "hc_mask"):
            r = getattr(ref, field)
            if r is not None and not torch.equal(getattr(got, field)[i], r):
                raise AssertionError(f"{what}: {field} differs")
    return near


def fleet_scorer_families(card):
    """Phase 16 (a): each of the 16 fleet keys over FLEET_USERS users'
    configs[4]-scale operands: rows against the single calls, one stacked
    dispatch (stacking included) timed against FLEET_USERS single calls."""
    users = fleet_operands()
    fleet, single = scoring.make_fleet_scoring_fns(k=Q), _single_scorers(Q)
    bit_equal, near, times = {}, {}, {}
    for key, names in FLEET_OPERANDS.items():
        cols = [[u[n] for u in users] for n in names]
        out = fleet[key](*[_stack_operand([x.clone() for x in col])
                           for col in cols])
        eq, nt = True, 0
        for i, u in enumerate(users):
            one = single[key](*[u[n].clone() for n in names])
            eq &= all(r is None or torch.equal(g[i], r)
                      for g, r in zip(out, one))
            nt += _compare_row(out, one, i, f"fleet {key} user {i}")
        bit_equal[key], near[key] = eq, nt

        def stacked(cols=cols, key=key):
            return fleet[key](*[_stack_operand(col) for col in cols])

        def singles(names=names, key=key):
            return [single[key](*[u[n] for n in names]) for u in users]

        times[key] = (time_ms(stacked, FLEET_REPS),
                      time_ms(singles, FLEET_REPS))
    n_bytes = FLEET_USERS * M * N * C * 4
    print(f"[fleet-scoring] 16 fleet keys over {FLEET_USERS} users x (M={M},"
          f" N={N}, C={C}) float32 ({n_bytes / 1e6:.1f} MB stacked), q={Q}:"
          f" every row against that user's single call, values within the "
          f"entropy gate, ids equal where values > -inf but for near-ties "
          f"{ {k: v for k, v in near.items() if v} or 0}; rows bit-equal "
          f"for {sum(bit_equal.values())} of 16 keys"
          + ("" if all(bit_equal.values()) else " (not: " + ", ".join(
              k for k, v in bit_equal.items() if not v) + ")"))
    print(f"[fleet-scoring] {card}: ms per stacked dispatch (stacking "
          f"included) vs {FLEET_USERS} single calls (CUDA events, median of "
          f"{FLEET_REPS}): " + ", ".join(
              f"{k} {a:.4f} vs {b:.4f}" for k, (a, b) in times.items()))
    del users
    torch.cuda.empty_cache()
    return {"bit_equal": bit_equal, "near": near, "ms": times}


def _union(spans):
    """Sorted, disjoint ``[lo, hi]`` intervals covering ``spans``."""
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def host_overlap(prof, host_steps):
    """The share of a stopped profile's device time (kernels and copies)
    spent while a pooled host step ran: the fleet's host/device overlap.
    Host steps are ``FleetReport.host_steps`` intervals, on the same
    unix-epoch ns clock as the profiler's events; ``None`` without device
    events or host steps."""
    dev = _union((e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA)
    host = _union((t0, t1) for _, t0, t1 in host_steps)
    if not dev or not host:
        return None
    both, j = 0, 0
    for lo, hi in dev:
        while j < len(host) and host[j][1] <= lo:
            j += 1
        k = j
        while k < len(host) and host[k][0] < hi:
            both += min(hi, host[k][1]) - max(lo, host[k][0])
            k += 1
    return both / sum(hi - lo for lo, hi in dev)


def _host_cohort():
    """HOST_COHORT AMG1608 users (USER_SONGS annotated songs of USER_FRAMES
    frames, drawn per user from the seed) and each one's REG_MEMBERS
    GaussianNB + REG_MEMBERS SGD members fitted by the port."""
    ids = list(range(1, FULL_SONGS + 1))
    out = []
    for i in range(HOST_COHORT):
        pool, labels, centers = full_user(ids, seed=SEED + 50 + i)
        out.append((UserData(f"u{i}", pool, labels),
                    fit_members(centers, REG_MEMBERS, SEED + 60 + 10 * i)))
    return out


def _run_arm(arm, cfg, entries, root, make_committee, retrain=None,
             trace=False):
    """One arm over a cohort, each user in a fresh workspace under
    ``root``: ``fleet`` through ``FleetScheduler``, ``seq`` through
    ``ALLoop`` one user after another.  Returns (wall s, paths, fleet
    report or None, with ``trace``: the busy share of the run and the
    share of its device time that overlaps host steps)."""
    from torch.profiler import ProfilerActivity, profile

    paths = [os.path.join(root, arm, str(d.user_id)) for d, _ in entries]
    for path in paths:
        os.makedirs(path)
    committees = [make_committee(m) for _, m in entries]
    report = None
    prof = profile(activities=[ProfilerActivity.CUDA]) if trace else None
    torch.cuda.synchronize()
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    if arm == "fleet":
        report = FleetReport()
        recs = FleetScheduler(
            cfg, retrain_epochs=retrain, host_workers=FLEET_HOST_WORKERS,
            report=report, device="cuda").run(
            [FleetUser(d.user_id, c, d, path, seed=SEED)
             for (d, _), c, path in zip(entries, committees, paths)])
        failed = [r["user"] for r in recs if r["error"] is not None]
        if failed:
            raise AssertionError(f"fleet {arm}: users {failed} failed: "
                                 f"{[r['error'] for r in recs]}")
    else:
        loop = ALLoop(cfg, retrain_epochs=retrain, pad_pool_to=USER_SONGS,
                      device="cuda")
        for (d, _), c, path in zip(entries, committees, paths):
            loop.run_user(c, d, path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = None
    if prof is not None:
        prof.stop()
        busy = (busy_share(prof, 1, wall),
                host_overlap(prof, report.host_steps) if report else None)
    return wall, paths, report, busy


def _same_runs(paths, ref_paths, what, tol=None):
    """Each user's queried songs equal, F1s equal (or within ``tol``) and,
    without ``tol``, ``al_state.json`` equal; returns whether every F1 and
    state was bit-equal."""
    exact = True
    for path, ref in zip(paths, ref_paths):
        m, r = read_metrics(path), read_metrics(ref)
        if sorted(m) != sorted(r):
            raise AssertionError(f"{what}: epochs {sorted(m)} {sorted(r)}")
        for e in m:
            if m[e].get("queried") != r[e].get("queried"):
                raise AssertionError(f"{what} {path} epoch {e}: queried "
                                     "songs differ")
            if m[e]["f1"] != r[e]["f1"]:
                exact = False
                if tol is None:
                    raise AssertionError(f"{what} {path} epoch {e}: F1s")
                np.testing.assert_allclose(m[e]["f1"], r[e]["f1"], **tol,
                                           err_msg=f"{what} epoch {e}")
        with open(os.path.join(path, "al_state.json")) as f, \
                open(os.path.join(ref, "al_state.json")) as g:
            same = json.load(f) == json.load(g)
        if not same and tol is None:
            raise AssertionError(f"{what} {path}: al_state.json differs")
        exact &= same
    return exact


def fleet_host_cohort(card):
    """Phase 16 (b): HOST_COHORT users with 5 GaussianNB + 5 SGD members,
    fleet against sequential, alternated FLEET_ROUNDS times, then a traced
    fleet run for the busy share."""
    entries = _host_cohort()
    cfg = ALConfig(queries=Q, epochs=FLEET_EPOCHS, mode="mc",
                   train_size=TRAIN_SIZE, seed=SEED, ckpt_dtype="float32")

    def committee(members):
        return Committee(copy.deepcopy(members))

    walls = {"fleet": [], "seq": []}
    summary = None
    with tempfile.TemporaryDirectory() as root:
        runs = {}
        for r in range(FLEET_ROUNDS):
            for arm in (("fleet", "seq") if r % 2 == 0 else ("seq", "fleet")):
                wall, paths, report, _ = _run_arm(
                    arm, cfg, entries, os.path.join(root, str(r)), committee)
                walls[arm].append(wall)
                runs[(r, arm)] = paths
                if report is not None and summary is None:
                    summary = report.summary(cohort=HOST_COHORT)
                    if summary.get("dispatch_failures"):
                        raise AssertionError("fleet-host: a stacked dispatch "
                                             "failed")
        ref = runs[(0, "seq")]
        for key, paths in runs.items():
            if key != (0, "seq"):
                _same_runs(paths, ref, f"fleet-host {key}")
        traced, _, _, (busy, overlap) = _run_arm(
            "fleet", cfg, entries, os.path.join(root, "traced"), committee,
            trace=True)
    ups = {arm: [HOST_COHORT / w for w in ws] for arm, ws in walls.items()}
    print(f"[fleet-host] {HOST_COHORT} AMG1608 users ({USER_SONGS} songs x "
          f"{USER_FRAMES} frames x {F} features each), {REG_MEMBERS} "
          f"GaussianNB + {REG_MEMBERS} SGD members, mc, {FLEET_EPOCHS} "
          f"iterations of q={Q}, {FLEET_HOST_WORKERS} host workers: each "
          f"user's queried songs, F1s and al_state.json equal in every fleet"
          f" and sequential run ({FLEET_ROUNDS} of each, alternated); "
          f"dispatches {summary['score_dispatches']}, mean device batch "
          f"{summary['mean_device_batch']}, occupancy "
          f"{summary['occupancy']}")
    print(f"[fleet-host] {card}: users/s (host clock) fleet " + ", ".join(
        f"{v:.4f}" for v in ups["fleet"]) + " vs sequential " + ", ".join(
        f"{v:.4f}" for v in ups["seq"]) + " (in run order, alternated); "
        f"device busy over a traced fleet run ({traced:.2f} s, "
        f"torch.profiler, device events only): " + (
            "not measured (no device events)" if busy is None else
            f"{busy[0]:.2%}, {busy[1]:.3f} ms") + "; device time overlapping"
        " host steps: " + ("not measured" if overlap is None
                           else f"{overlap:.2%}"))
    return {"users_per_s": ups, "summary": summary, "busy": busy,
            "overlap": overlap}


def fleet_full_cohort(card, user, host):
    """Phase 16 (c): FULL_COHORT users over phase 14's store with the
    paper's committee at full width, mc and qbdc, fleet against sequential
    on the card; ``fit_many_users`` against per-user ``fit_many``.  cuDNN is
    held to its deterministic algorithms for both arms: a backward-filter
    algorithm summing with atomics would part two runs of one user after
    its first retrain."""
    cfg_cnn = CNNConfig()
    store, ids = user["store"], user["ids"]
    cnns = full_cnn_members(cfg_cnn, None, None, SEED + 70, "cuda",
                            fit=False)
    entries = []
    for i in range(FULL_COHORT):
        pool, labels, _ = full_user(ids, seed=SEED + 80 + i)
        entries.append((UserData(f"u{i}", pool, labels, store=store),
                        None))

    def committee(_):
        return Committee(copy.deepcopy(host), copy.deepcopy(cnns), cfg_cnn,
                         device="cuda")

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    walls, exact, plans, busy, overlap = {}, {}, {}, None, None
    try:
        with tempfile.TemporaryDirectory() as root:
            for mode, epochs in FULL_FLEET_EPOCHS.items():
                cfg = ALConfig(queries=Q, epochs=epochs, mode=mode,
                               train_size=TRAIN_SIZE, seed=SEED,
                               qbdc_k=QBDC_K, ckpt_dtype="float32")
                order = ("seq", "fleet") if mode == "mc" else ("fleet",
                                                               "seq")
                paths = {}
                for arm in order:
                    traced = arm == "fleet" and mode == "qbdc"
                    wall, paths[arm], report, b = _run_arm(
                        arm, cfg, entries, os.path.join(root, mode),
                        committee, retrain=FLEET_RETRAIN, trace=traced)
                    walls[f"{mode} {arm}"] = wall
                    if traced:
                        busy, overlap = b
                    if report is not None:
                        summ = report.summary(cohort=FULL_COHORT)
                        if summ.get("dispatch_failures"):
                            raise AssertionError(f"fleet-full {mode}: a "
                                                 "stacked dispatch failed")
                        plans[mode] = {
                            fn: (v["dispatches"], v["mean_batch"])
                            for fn, v in summ["cnn"].items()
                            if isinstance(v, dict)}
                        if summ["cnn"]["mean_device_batch"] <= 1:
                            raise AssertionError(f"fleet-full {mode}: no "
                                                 "stacked CNN dispatch")
                    torch.cuda.empty_cache()
                exact[mode] = _same_runs(paths["fleet"], paths["seq"],
                                         f"fleet-full {mode}", CNN_TOL)
        fit = fleet_fit_check(cfg_cnn, store, cnns, entries)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"[fleet-full] {FULL_COHORT} AMG1608 users over phase 14's store "
          f"({FULL_SONGS} clips on the card), {FULL_MEMBERS} GaussianNB + "
          f"{FULL_MEMBERS} SGD + {FULL_MEMBERS} GBDT + {FULL_MEMBERS} vgg "
          f"members at full width, {FLEET_RETRAIN} retrain epochs, "
          f"iterations {FULL_FLEET_EPOCHS} (qbdc K={QBDC_K}), cuDNN "
          f"deterministic: each user's fleet run equals its sequential run "
          f"(queried songs equal, F1s within {CNN_TOL}; bit-equal F1s and "
          f"state {exact}); stacked CNN dispatches (count, mean users) "
          f"{plans}; dispatch_failed 0")
    print(f"[fleet-full] {card}: wall s (host clock) " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items()) + "; device busy over the"
          " traced qbdc fleet run (torch.profiler, device events only): " + (
              "not measured (no device events)" if busy is None else
              f"{busy[0]:.2%}, {busy[1]:.1f} ms") + ", of it overlapping "
          "host steps: " + ("not measured" if overlap is None
                            else f"{overlap:.2%}"))
    print(f"[fleet-full] {card}: fit_many_users of {FLEET_FIT_USERS} users x "
          f"{FLEET_FIT_MEMBERS} full-width members, {FLEET_FIT_EPOCHS} epochs"
          f" ({Q} train, 60 test songs) against per-user fit_many: "
          f"histories and variables bit-equal {fit['exact']}, losses within "
          f"{FIT_TOL}; {fit['wall']:.1f} s vs {fit['ref_wall']:.1f} s")
    return {"walls": walls, "exact": exact, "plans": plans, "busy": busy,
            "overlap": overlap, "fit": fit}


def fleet_fit_check(cfg_cnn, store, cnns, entries):
    """``fit_many_users`` against per-user ``fit_many`` on the card."""
    trainer = CNNTrainer(cfg_cnn, TrainConfig())
    users = []
    for u, (data, _) in enumerate(entries[:FLEET_FIT_USERS]):
        songs = list(data.pool.song_ids)
        y = one_hot_np([data.labels[s] for s in songs])
        users.append(dict(
            variables_list=[m.variables for m in cnns[:FLEET_FIT_MEMBERS]],
            store=store, train_ids=songs[:Q], train_y=y[:Q],
            test_ids=songs[Q:Q + 60], test_y=y[Q:Q + 60],
            key=prng.key(SEED + 90 + u, "cpu")))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = trainer.fit_many_users(users, n_epochs=FLEET_FIT_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    exact = True
    t0 = time.perf_counter()
    for u, (best, hist) in zip(users, got):
        rbest, rhist = trainer.fit_many(
            u["variables_list"], store, u["train_ids"], u["train_y"],
            u["test_ids"], u["test_y"], u["key"], n_epochs=FLEET_FIT_EPOCHS)
        for h, rh in zip(hist, rhist):
            for e, re_ in zip(h, rh):
                for k in ("train_loss", "val_loss"):
                    np.testing.assert_allclose(e[k], re_[k], **FIT_TOL,
                                               err_msg=f"fit_many_users {k}")
        exact &= hist == rhist and all(
            torch.equal(b[k], rb[k]) for b, rb in zip(best, rbest)
            for k in b)
    torch.cuda.synchronize()
    return {"exact": exact, "wall": wall,
            "ref_wall": time.perf_counter() - t0}


def fleet_cli_runs(root, amg_root, registry_root, seq):
    """Phase 16 (d), on phase 11's tree: ``amg_test --fleet 2`` on the card
    and the CPU for FLEET_CLI_EPOCHS iterations; each user's metrics equal
    its sequential run's (``seq``: phase 11's per device) over those
    iterations."""
    args = list(CLI_ARGS)
    args[args.index("-e") + 1] = str(FLEET_CLI_EPOCHS)
    walls, summaries = {}, {}
    for d in ("cuda", "cpu"):
        models = os.path.join(root, f"models_fleet_{d}")
        shutil.copytree(os.path.join(registry_root, "pretrained"),
                        os.path.join(models, "pretrained"))
        linear_mc.launches = 0
        t0 = time.perf_counter()
        text = run_cli(args + ["--fleet", "2", "--models-root", models,
                               "--amg-root", amg_root, "--device", d])
        walls[d] = time.perf_counter() - t0
        if linear_mc.launches or "Fleet cohort of 2 users" not in text:
            raise AssertionError(f"fleet-cli {d}: no fleet cohort, or "
                                 f"linear_mc launched:\n{text[-2000:]}")
        got = users_metrics(models)
        if sorted(got) != sorted(seq[d]):
            raise AssertionError(f"fleet-cli {d}: users {sorted(got)}")
        for u, (m, st) in got.items():
            ref = seq[d][u][0]
            for e in range(-1, FLEET_CLI_EPOCHS):
                if (m[e].get("queried") != ref[e].get("queried")
                        or m[e]["f1"] != ref[e]["f1"]):
                    raise AssertionError(f"fleet-cli {d} user {u} epoch "
                                         f"{e}: differs from the sequential "
                                         "CLI")
            if st.next_epoch != FLEET_CLI_EPOCHS:
                raise AssertionError(f"fleet-cli {d} user {u}: state at "
                                     f"{st.next_epoch}")
        with open(os.path.join(models, "users", "fleet_metrics.jsonl")) as f:
            summaries[d] = [json.loads(line) for line in f][-1]
        if summaries[d].get("event") != "fleet_summary":
            raise AssertionError(f"fleet-cli {d}: no fleet summary")
    return {"walls": walls, "summaries": summaries, "args": args}


def fleet_cli_alone(card):
    """Phase 16 (d) without phase 11: its tree and registry, the
    sequential CLI for FLEET_CLI_EPOCHS iterations on each device, then the
    fleet CLI."""
    with tempfile.TemporaryDirectory() as root:
        amg_root = write_amg_tree(root)
        registry = os.path.join(root, "models_registry")
        write_registry(registry)
        args = list(CLI_ARGS)
        args[args.index("-e") + 1] = str(FLEET_CLI_EPOCHS)
        seq = {}
        for d in ("cuda", "cpu"):
            models = os.path.join(root, f"models_seq_{d}")
            shutil.copytree(os.path.join(registry, "pretrained"),
                            os.path.join(models, "pretrained"))
            run_cli(args + ["--models-root", models, "--amg-root", amg_root,
                            "--device", d])
            seq[d] = users_metrics(models)
        return fleet_cli_runs(root, amg_root, registry, seq)


def phase_fleet(card, user=None, host=None, cli=None):
    """Phase 16: the fleet engine on the card, (a)-(d).  ``user`` and
    ``host`` are phase 14's (built here when absent), ``cli`` phase 11's
    (d) result (run here when absent).  No hand kernel is launched."""
    if user is None:
        user = amg_user_on_card()
        host = full_host_members(user["centers"], SEED + 18)
    if cli is None:
        cli = fleet_cli_alone(card)
    linear_mc.launches = 0
    out, walls = {"cli": cli}, {}
    for part, run in (("scoring", lambda: fleet_scorer_families(card)),
                      ("host", lambda: fleet_host_cohort(card)),
                      ("full", lambda: fleet_full_cohort(card, user,
                                                         host))):
        t0 = time.perf_counter()
        out[part] = run()
        walls[part] = time.perf_counter() - t0
    if linear_mc.launches:
        raise AssertionError(f"fleet: {linear_mc.launches} linear_mc "
                             "launches on a path without the kernel")
    summ = {d: {k: s.get(k) for k in ("mean_device_batch", "occupancy",
                                      "score_dispatches")}
            for d, s in cli["summaries"].items()}
    print(f"[fleet-cli] {card}: amg_test {' '.join(cli['args'])} --fleet 2 "
          f"on phase 11's tree, card and CPU: each user's metrics.jsonl "
          f"equal to the sequential CLI's over those iterations, state "
          f"committed; fleet summary {summ}; wall s " + ", ".join(
              f"{d} {w:.1f}" for d, w in cli["walls"].items()))
    print(f"[fleet] linear_mc launches over phase 16: {linear_mc.launches};"
          f" host clock, s: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in walls.items()))
    return out


# -- slice 8: DEAM pre-training and the evidence experiment ----------------


def write_deam_tree(root, seed=SEED + 30):
    """A DEAM tree at the dataset's scale: DEAM_SONGS per-song openSMILE
    CSVs (``;``, frameTime and the F feature columns, DEAM_FRAMES frames
    at 0.5 s from 15.0 s), ``arousal.csv`` / ``valence.csv`` with
    ``sample_{ms}ms`` columns to 45 s (most rows end in a NaN, a few songs
    lose 1-3 more frames in one table: length mismatches), and a seeded
    DEAM_CLIP_S-s clip a song in ``npy/``.  Features are multiples of 1/256
    (short decimals, as openSMILE prints few); songs are class-separable by
    their annotation quadrant."""
    rng = np.random.default_rng(seed)
    deam_root = os.path.join(root, "deam")
    feats = os.path.join(deam_root, "features")
    anno = os.path.join(deam_root, "annotations")
    npy = os.path.join(deam_root, "npy")
    for d in (feats, anno, npy):
        os.makedirs(d)
    middle = [f"feat_{i}" for i in range(F - 2)]
    header = ";".join(["frameTime", FEATURE_SLICE_START, *middle,
                       FEATURE_SLICE_STOP])
    cells = np.array([repr(c / 256) for c in range(-32768, 32768)])
    song_ids = np.sort(rng.choice(np.arange(2, 2059), DEAM_SONGS,
                                  replace=False))
    target = rng.integers(0, C, DEAM_SONGS)
    centers = rng.normal(0, 2.0, (C, F)) + rng.uniform(-5, 5, F)
    times = 15.0 + 0.5 * np.arange(DEAM_FRAMES)
    n_cols = DEAM_FRAMES + 1  # to 45.0 s: most rows' last value is NaN
    a_rows, v_rows = [], []
    for sid, c in zip(song_ids, target):
        x = centers[c] + rng.standard_normal((DEAM_FRAMES, F)) * 3.0
        codes = np.clip(np.rint(x * 256), -32768, 32767).astype(np.int64)
        lines = [f"{t:.1f};" + ";".join(r) for t, r in
                 zip(times, cells[codes + 32768].tolist())]
        with open(os.path.join(feats, f"{sid}.csv"), "w") as f:
            f.write(header + "\n" + "\n".join(lines) + "\n")
        a_sign = 1.0 if c in (0, 1) else -1.0  # the DEAM geometry
        v_sign = 1.0 if c in (0, 3) else -1.0
        a = np.round(a_sign * rng.uniform(0.05, 1.0, n_cols), 4)
        v = np.round(v_sign * rng.uniform(0.05, 1.0, n_cols), 4)
        flip = rng.random(n_cols) < 0.08  # some frames cross an axis
        a[flip] *= -1
        if rng.random() < 0.9:
            a[-1] = v[-1] = np.nan
        if rng.random() < 0.03:  # a length mismatch
            (a if rng.random() < 0.5 else v)[-int(rng.integers(2, 5)):] = \
                np.nan
        a_rows.append((sid, a))
        v_rows.append((sid, v))
    cols = ",".join(["song_id"] + [f"sample_{int(t * 1000)}ms" for t in
                                   15.0 + 0.5 * np.arange(n_cols)])
    for name, rows in (("arousal", a_rows), ("valence", v_rows)):
        with open(os.path.join(anno, f"{name}.csv"), "w") as f:
            f.write(cols + "\n")
            for sid, vals in rows:
                f.write(f"{sid}," + ",".join(
                    "" if np.isnan(x) else repr(float(x)) for x in vals)
                    + "\n")
    # each clip: its class's tone plus a window of one seeded noise bank
    n = DEAM_CLIP_S * 16000
    t = np.arange(n, dtype=np.float32) / np.float32(16000)
    tones = [np.sin(2 * np.pi * f0 * t).astype(np.float32) * 0.5
             for f0 in (220.0, 440.0, 784.0, 831.0)]
    bank = rng.standard_normal(4 * n, np.float32) * np.float32(0.1)
    for sid, c, off in zip(song_ids, target,
                           rng.integers(0, 3 * n, DEAM_SONGS)):
        np.save(os.path.join(npy, f"{sid}.npy"), tones[c] + bank[off:off + n])
    return deam_root, [int(s) for s in song_ids]


def run_pretrain_cli(args):
    """``deam_classifier.main`` in this process, its chatter kept off
    stdout; returns its output."""
    from consensus_entropy_tpu_torch.cli import deam_classifier

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = deam_classifier.main(args)
    if rc != 0:
        raise AssertionError(f"pretrain: main({args}) exited {rc}:\n"
                             f"{out.getvalue()[-2000:]}")
    return out.getvalue()


@contextlib.contextmanager
def xgb_rounds(n):
    """The boosted member's ``n_estimators`` default set to ``n`` while the
    block runs (the pre-trainer builds it with its defaults)."""
    defaults = NativeGBDTMember.__init__.__kwdefaults__
    before = defaults["n_estimators"]
    defaults["n_estimators"] = n
    try:
        yield
    finally:
        defaults["n_estimators"] = before


def last_pretrain_record(pre):
    with open(os.path.join(pre, "pretrain_metrics.jsonl")) as f:
        return json.loads(f.readlines()[-1])


@contextlib.contextmanager
def captured(owner, name, sink):
    """Wraps ``owner.name`` so each call's (self or first argument, result)
    lands in ``sink`` while the block runs."""
    real = getattr(owner, name)

    def wrapper(*a, **kw):
        out = real(*a, **kw)
        sink.append((a[0] if a else None, out))
        return out

    setattr(owner, name, wrapper)
    try:
        yield sink
    finally:
        setattr(owner, name, real)


def sgd_core_vs_plain(X, y):
    """(b): one of the SGD member's one-vs-all problems (class 0 against
    the rest, from zero weights) over every row of ``X``, SGD_CHECK_EPOCHS
    epochs, through the host core and through its Python plain version;
    weights, intercept and epochs must be bit-equal.  Returns the host-
    clock seconds of each."""
    from consensus_entropy_tpu_torch.models.members import plain_sgd

    y0 = (y == 0).astype(X.dtype)
    out, secs = {}, {}
    for route in ("core", "plain"):
        w = np.zeros(X.shape[1], X.dtype)
        t0 = time.perf_counter()
        r = plain_sgd(w, 0.0, X, y0, seed=SEED, max_iter=SGD_CHECK_EPOCHS,
                      t=1.0, alpha=1e-4, tol=1e-3, n_iter_no_change=5,
                      plain=route == "plain")
        secs[route] = time.perf_counter() - t0
        out[route] = (w, r)
    (w_core, r_core), (w_plain, r_plain) = out["core"], out["plain"]
    if r_core != r_plain or not np.array_equal(w_core, w_plain):
        raise AssertionError(
            f"pretrain: the SGD core differs from its plain version "
            f"(intercept, epochs {r_core} vs {r_plain}, max |dw| "
            f"{np.abs(w_core - w_plain).max():.3e})")
    return secs


def phase_sgd_fold(card):
    """``chip_smoke.py --sgd-fold``, not part of the default run: one
    DEAM-scale SGD fold (``pretrain_classic``, ``-cv 1``) through the host
    core, then with every one-vs-all problem in the Python plain version;
    the fold members' coefficients, intercepts and epochs must be
    bit-equal; then (b)'s one-problem check.  Prints the host-clock
    seconds of each."""
    import functools

    from consensus_entropy_tpu_torch.data import deam
    from consensus_entropy_tpu_torch.models import members
    from consensus_entropy_tpu_torch.train import pretrain

    native.build()
    real = members.plain_sgd
    with tempfile.TemporaryDirectory() as root:
        deam_root, _ = write_deam_tree(root)
        X, y, sids = deam.training_arrays(
            deam.load_dataset(*deam_paths(deam_root)))
        ova = sgd_core_vs_plain(X, y)
        secs, fitted = {}, {}
        for route in ("core", "plain"):
            out = os.path.join(root, route)
            if route == "plain":
                members.plain_sgd = functools.partial(real, plain=True)
            try:
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    pretrain.pretrain_classic("sgd", X, y, sids, cv=1,
                                              out_dir=out)
                secs[route] = time.perf_counter() - t0
            finally:
                members.plain_sgd = real
            fitted[route] = members.SGDMember.load(
                os.path.join(out, "classifier_sgd.it_0.npz"))
    core, plain = fitted["core"], fitted["plain"]
    if not (np.array_equal(core.coef_, plain.coef_)
            and np.array_equal(core.intercept_, plain.intercept_)
            and core.n_iter_ == plain.n_iter_):
        raise AssertionError("sgd-fold: the core's fold member differs "
                             "from the plain version's")
    print(f"[sgd-fold] {card}: -cv 1 -m sgd fold at DEAM scale ({len(X)} "
          f"frames x {X.shape[1]} features, 4 one-vs-all problems, n_iter_ "
          f"{core.n_iter_}; pretrain_classic, host clock, data load "
          f"excluded): core {secs['core']:.3f} s, plain {secs['plain']:.3f} "
          f"s, members bit-equal; one one-vs-all problem over all frames, "
          f"{SGD_CHECK_EPOCHS} epochs: core {ova['core']:.3f} s, plain "
          f"{ova['plain']:.3f} s, bit-equal")


def pretrain_cnn_fold(deam_root, models, flags, pre):
    """(d): ``-cv 1 -m cnn_jax --epochs PRE_CNN_EPOCHS`` at full width,
    each epoch timed; then the same fold with ``resume=True`` on the CLI's
    own store: skipped, the file unchanged."""
    from consensus_entropy_tpu_torch.data import audio, deam
    from consensus_entropy_tpu_torch.train import pretrain

    epochs, stores, real = [], [], CNNTrainer._epoch

    def timed_epoch(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, *a, **kw)
        torch.cuda.synchronize()
        epochs.append((time.perf_counter() - t0, len(a[2])))  # train rows
        return out

    CNNTrainer._epoch = timed_epoch
    try:
        with captured(audio, "device_store_from_npy", stores):
            t0 = time.perf_counter()
            run_pretrain_cli(["-cv", "1", "-m", "cnn_jax", "--epochs",
                              str(PRE_CNN_EPOCHS)] + flags)
            cnn_s = time.perf_counter() - t0
    finally:
        CNNTrainer._epoch = real
    if len(epochs) != PRE_CNN_EPOCHS:
        raise AssertionError(f"pretrain cnn: {len(epochs)} epochs")
    f1 = last_pretrain_record(pre)["fold_f1"][0]
    fold = os.path.join(pre, "classifier_cnn.it_0.npz")
    with open(fold, "rb") as f:
        before = f.read()
    store = stores[0][1]
    table = deam.load_dataset(*deam_paths(deam_root))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pretrain.pretrain_cnn(deam.song_labels(table), store, cv=1,
                              out_dir=pre, config=CNNConfig(),
                              n_epochs=PRE_CNN_EPOCHS, seed=SEED,
                              resume=True)
    with open(fold, "rb") as f:
        same = f.read() == before
    if "fold 0: resuming from" not in out.getvalue() or not same:
        raise AssertionError("pretrain cnn: the resumed fold was not "
                             "skipped, or its file changed")
    resumed_f1 = last_pretrain_record(pre)["fold_f1"][0]
    del store, stores
    torch.cuda.empty_cache()
    ms = [1000 * s for s, _ in epochs]
    steps = -(-epochs[0][1] // TrainConfig().batch_size)
    return {"cnn_s": cnn_s, "epoch_ms": ms, "steps": steps,
            "step_ms": statistics.median(ms) / steps,
            "n_train": epochs[0][1], "f1": f1, "resumed_f1": resumed_f1}


def deam_paths(deam_root):
    anno = os.path.join(deam_root, "annotations")
    return (os.path.join(deam_root, "features"),
            os.path.join(anno, "arousal.csv"),
            os.path.join(anno, "valence.csv"),
            os.path.join(deam_root, "dataset_quads.csv"))


def evidence_card_vs_cpu(root):
    """(f): ``evidence sweep`` on the card and on the CPU, every scoring
    result recorded; then ``evidence analyze`` over the card's workdir."""
    from consensus_entropy_tpu_torch.cli import evidence as evidence_cli

    runs, walls = {}, {}
    for d in ("cuda", "cpu"):
        out = os.path.join(root, f"evidence_{d}.json")
        t0 = time.perf_counter()
        with recorded_scoring() as picks, \
                contextlib.redirect_stdout(io.StringIO()):
            rc = evidence_cli.main(EVIDENCE_ARGS + [
                "--workdir", os.path.join(root, f"ev_{d}"), "--out", out,
                "--device", d])
        walls[d] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"evidence sweep on {d} exited {rc}")
        with open(out) as f:
            runs[d] = (json.load(f), picks)
    (card, card_picks), (host, host_picks) = runs["cuda"], runs["cpu"]
    if len(card_picks) != len(host_picks):
        raise AssertionError(f"evidence: {len(card_picks)} card scoring "
                             f"calls, {len(host_picks)} on the CPU")
    near = sum(_compare_slots(a, b, f"evidence scoring call {i}")
               for i, (a, b) in enumerate(zip(card_picks, host_picks)))
    split = [(m, s) for m in card["raw"] for s in card["raw"][m]
             if card["raw"][m][s] != host["raw"][m][s]]
    if split and not near:
        raise AssertionError(f"evidence: trajectories {split} differ with "
                             "no near-tie split")
    if not split and card != host:
        raise AssertionError("evidence: card and CPU reports differ")
    out = os.path.join(root, "analyze.json")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = evidence_cli.main(["analyze", os.path.join(root, "ev_cuda"),
                                "--out", out, "--device", "cuda"])
    with open(out) as f:
        analysis = json.load(f)
    for name, t in card["tests"].items():
        if analysis["tests"][name]["per_member_final"] != \
                t["per_member_final"]:
            raise AssertionError(f"evidence analyze {name}: "
                                 f"{analysis['tests'][name]} vs {t}")
    return {"walls": walls, "near": near, "split": split,
            "calls": len(card_picks), "tests": card["tests"],
            "trajectories": card["trajectories"]}


def phase_pretrain(card):
    """Phase 17: DEAM pre-training and the evidence experiment, (a)-(f).
    No hand kernel is launched."""
    from consensus_entropy_tpu_torch.data import deam

    linear_mc.launches = 0
    t17 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        deam_root, song_ids = write_deam_tree(root)
        tree_s = time.perf_counter() - t0
        models = os.path.join(root, "models")
        pre = os.path.join(models, "pretrained")
        flags = ["--models-root", models, "--deam-root", deam_root]
        paths = deam_paths(deam_root)
        # (a) the join, cold (writes the cache), then warm
        times, tables = {}, []
        for what in ("cold", "warm"):
            t0 = time.perf_counter()
            tables.append(deam.load_dataset(*paths))
            times[what] = time.perf_counter() - t0
        cold, warm = tables
        if not warm.equals(cold) or len(cold) < DEAM_SONGS * (
                DEAM_FRAMES - 1):
            raise AssertionError(f"pretrain: the warm table differs from "
                                 f"the cold one ({len(cold)} rows)")
        X, y, _ = deam.training_arrays(cold)
        n_rows, n_songs = len(cold), len(np.unique(cold.song_id))
        del tables, cold, warm
        sgd_secs = sgd_core_vs_plain(X, y)
        # (b) gnb and sgd, CV folds; (c) one 100-round xgb fold
        walls = {}
        for model, cv, extra in (("gnb", PRE_CV, []),
                                 ("sgd", PRE_CV, ["--n-jobs",
                                                  str(PRE_CV)])):
            t0 = time.perf_counter()
            run_pretrain_cli(["-cv", str(PRE_CV), "-m", model] + extra
                             + flags + ["--device", "cuda"])
            walls[model] = time.perf_counter() - t0
            rec = last_pretrain_record(pre)
            if rec["model"] != model or len(rec["fold_f1"]) != cv:
                raise AssertionError(f"pretrain {model}: {rec}")
        saved = []
        with captured(NativeGBDTMember, "save", saved), \
                xgb_rounds(PRE_XGB_ROUNDS):
            t0 = time.perf_counter()
            run_pretrain_cli(["-cv", "1", "-m", "xgb"] + flags
                             + ["--device", "cuda"])
            walls["xgb"] = time.perf_counter() - t0
        xgb_rec = last_pretrain_record(pre)
        member = saved[0][0]
        reloaded = NativeGBDTMember.load(
            os.path.join(pre, "classifier_xgb.it_0.npz"))
        probe = X[:: max(1, len(X) // 20000)]
        if member.model.n_trees != PRE_XGB_ROUNDS * C or not np.array_equal(
                reloaded.predict_proba(probe), member.predict_proba(probe)):
            raise AssertionError(f"pretrain xgb: the reloaded member's "
                                 f"probabilities differ, or not "
                                 f"{PRE_XGB_ROUNDS} rounds")
        del saved, member, reloaded, X, y
        # (d) one CNN fold at full vgg width, then resume
        cnn = pretrain_cnn_fold(deam_root, models,
                                flags + ["--device", "cuda"], pre)
        files = sorted(f for f in os.listdir(pre) if f.endswith(".npz"))
        want = ([f"classifier_gnb.it_{i}.npz" for i in range(PRE_CV)]
                + [f"classifier_sgd.it_{i}.npz" for i in range(PRE_CV)]
                + ["classifier_xgb.it_0.npz", "classifier_cnn.it_0.npz"])
        if files != sorted(want):
            raise AssertionError(f"pretrain: registry {files}")
        # (e) the registry personalized by amg_test on phase 11's tree
        t0 = time.perf_counter()
        amg_root = write_amg_tree(root)
        write_npy_tree(amg_root)
        run_cli(PIPELINE_ARGS + ["--models-root", models, "--amg-root",
                                 amg_root, "--device", "cuda"])
        walls["amg_test"] = time.perf_counter() - t0
        users = os.path.join(models, "users")
        (uid,) = [u for u in os.listdir(users)
                  if os.path.isdir(os.path.join(users, u))]
        recs = read_metrics(os.path.join(users, uid, "mc"))
        if sorted(recs) != [-1, 0] or any(
                len(r["f1"]) != len(want) or not np.all(np.isfinite(r["f1"]))
                for r in recs.values()):
            raise AssertionError(f"pipeline: metrics {recs}")
        # (f) the evidence sweep, card against CPU, and its analysis
        ev = evidence_card_vs_cpu(root)
    total = time.perf_counter() - t17
    if linear_mc.launches:
        raise AssertionError(f"pretrain: {linear_mc.launches} linear_mc "
                             "launches on a path without the kernel")
    print(f"[pretrain] {card}: DEAM tree of {n_songs} songs ({n_rows} "
          f"frames x {F} features, {DEAM_CLIP_S}-s clips) written in "
          f"{tree_s:.1f} s; load_dataset cold {times['cold']:.2f} s (cache "
          f"written), warm {times['warm']:.2f} s, tables equal; -cv "
          f"{PRE_CV} gnb {walls['gnb']:.1f} s, sgd (--n-jobs {PRE_CV}) "
          f"{walls['sgd']:.1f} s; the SGD core on one one-vs-all problem "
          f"over all {n_rows} frames, {SGD_CHECK_EPOCHS} epochs, "
          f"bit-equal to its plain version: core {sgd_secs['core']:.3f} s, "
          f"plain {sgd_secs['plain']:.3f} s; -cv 1 xgb ({PRE_XGB_ROUNDS} "
          f"rounds x {C} "
          f"classes) "
          f"{walls['xgb']:.1f} s, fold F1 {xgb_rec['fold_f1'][0]}, the "
          f"reloaded member's probabilities bit-equal")
    print(f"[pretrain-cnn] {card}: -cv 1 -m cnn_jax --epochs "
          f"{PRE_CNN_EPOCHS} at full vgg width, {cnn['n_train']} train "
          f"songs ({cnn['steps']} steps of {TrainConfig().batch_size}): "
          f"ms per epoch " + ", ".join(f"{m:.1f}" for m in cnn["epoch_ms"])
          + f", ms per step {cnn['step_ms']:.2f} (validation included); "
          f"CLI {cnn['cnn_s']:.1f} s; fold F1 {cnn['f1']}; resume skipped "
          f"the fold (file unchanged, F1 {cnn['resumed_f1']})")
    print(f"[pipeline] {card}: amg_test {' '.join(PIPELINE_ARGS)} on the "
          f"pretrained registry ({len(want)} members) over phase 11's tree "
          f"in {walls['amg_test']:.1f} s, final F1s "
          f"{[round(v, 4) for v in recs[0]['f1']]}")
    print(f"[evidence] {card}: evidence {' '.join(EVIDENCE_ARGS)} on the "
          f"card {ev['walls']['cuda']:.1f} s and the CPU "
          f"{ev['walls']['cpu']:.1f} s: {ev['calls']} scoring calls within "
          f"the gate, {ev['near']} slots split by near-ties, trajectories "
          + ("equal" if not ev["split"] else f"split at {ev['split']}")
          + "; analyze equals the sweep's tests; mean trajectories "
          + json.dumps(ev["trajectories"]) + "; per-member p "
          + ", ".join(f"{k} {v['per_member_final']['p']:.4f}"
                      for k, v in ev["tests"].items()))
    print(f"[pretrain] linear_mc launches over phase 17: "
          f"{linear_mc.launches}; phase 17 {total:.1f} s")


# -- slice 9: the pool-axis mesh -------------------------------------------


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_cli_runs(root, amg_root, cnn):
    """Phase 18 (d), on phase 11's tree: ``amg_test -m mc`` with the vgg
    registry (CLI_CNN_ARGS) over a 2-way mesh on the one card, then over
    ``--mesh auto --distributed`` at world size 1 (NCCL); each run's
    queried songs equal phase 11's unmeshed card run's every epoch (F1s
    compared too); ``--mesh 2`` is refused where the machine has one
    card."""
    ref = read_metrics(cnn["paths"][("mc", "cuda")])
    runs = {"mesh cuda:0,cuda:0": ["--mesh", "cuda:0,cuda:0"],
            "mesh auto, distributed 1 process": [
                "--mesh", "auto", "--distributed",
                f"127.0.0.1:{_free_port()},1,0"]}
    t_all = time.perf_counter()
    walls, f1_diff = {}, {}
    for i, (name, extra) in enumerate(runs.items()):
        models = os.path.join(root, f"models_mesh_{i}")
        shutil.copytree(os.path.join(cnn["bases"]["vgg"], "pretrained"),
                        os.path.join(models, "pretrained"))
        linear_mc.launches = 0
        t0 = time.perf_counter()
        try:
            text = run_cli(CLI_CNN_ARGS + [
                "-m", "mc", "--models-root", models, "--amg-root", amg_root,
                "--device", "cuda", "--cnn-config-json",
                json.dumps(CLI_CNN)] + extra)
        finally:
            multihost.shutdown()
        walls[name] = time.perf_counter() - t0
        if "Scoring mesh" not in text or "Training mesh" not in text:
            raise AssertionError(f"mesh-cli {name}: no mesh:\n"
                                 f"{text[-2000:]}")
        if linear_mc.launches:
            raise AssertionError(f"mesh-cli {name}: linear_mc launched")
        users = os.path.join(models, "users")
        (uid,) = os.listdir(users)
        recs = read_metrics(os.path.join(users, uid, "mc"))
        if sorted(recs) != sorted(ref):
            raise AssertionError(f"mesh-cli {name}: epochs {sorted(recs)}")
        for e in ref:
            if recs[e].get("queried") != ref[e].get("queried"):
                raise AssertionError(f"mesh-cli {name} epoch {e}: queried "
                                     "songs differ from phase 11's run")
        f1_diff[name] = max(float(np.max(np.abs(
            np.subtract(recs[e]["f1"], ref[e]["f1"])))) for e in ref)
    refused = None
    if torch.cuda.device_count() < 2:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = amg_test.main(CLI_CNN_ARGS + [
                "-m", "mc", "--models-root", cnn["bases"]["vgg"],
                "--amg-root", amg_root, "--device", "cuda", "--mesh", "2",
                "--cnn-config-json", json.dumps(CLI_CNN)])
        refused = out.getvalue().strip().splitlines()[-1]
        if rc != 1 or "have 1 device(s)" not in refused:
            raise AssertionError(f"mesh-cli: --mesh 2 on one card: exit "
                                 f"{rc}, {refused!r}")
    return {"walls": walls, "f1_diff": f1_diff, "refused": refused,
            "wall_s": time.perf_counter() - t_all}


def phase_mesh(card, x, w, b, mask, tables, hc, mesh_cli):
    """The pool-axis mesh on the one card: (a) B2, (b) the fused modes,
    (c) sequence parallelism at full width, (d) the CLI (run in phase
    11).  Returns the kernel line's additions."""
    # (a) B2 at configs[4] scale
    mesh = make_pool_mesh(["cuda:0"] * MESH_B2_SHARDS)
    xt = torch.from_numpy(x).cuda()
    w_p, b_p = linear_members_from_jax(w, b, "cuda")
    mt = torch.from_numpy(mask).cuda()
    xs = ShardedRows.split(xt, mesh.device_list, 0)
    ms = ShardedRows.split(mt, mesh.device_list, 0)
    scorer = sharding.make_shardmap_pallas_mc_scorer(mesh, n_members=M, k=Q)
    torch.cuda.synchronize()
    linear_mc.launches = 0
    got = scorer(xs, w_p, b_p, ms)
    torch.cuda.synchronize()
    launches = linear_mc.launches
    if launches != MESH_B2_SHARDS:
        raise AssertionError(f"mesh B2: {launches} linear_mc launches for "
                             f"one select over {MESH_B2_SHARDS} shards")
    worst = 0.0
    for s in range(MESH_B2_SHARDS):
        plain = linear_mc.plain_masked_entropy(xs.blocks[s], w_p, b_p,
                                               ms.blocks[s], M)
        worst = max(worst, check_entropy(got.entropy.blocks[s], plain,
                                         f"mesh B2 shard {s}"))
    check_split(worst, "mesh B2 shards")
    ent1, v1, i1 = linear_mc.linear_score_mc(xt, w_p, b_p, mt, n_members=M,
                                             k=Q, fuse_topk=True)
    split = check_selection((got.values, got.indices), (v1, i1),
                            got.entropy.full(), ent1, "mesh B2 top-k")
    sharded_ms = time_ms(lambda: scorer(xs, w_p, b_p, ms))
    single_ms = time_ms(lambda: linear_mc.linear_score_mc(
        xt, w_p, b_p, mt, n_members=M, k=Q, fuse_topk=True))
    del xt, xs, ent1
    print(f"[mesh] {card}: (a) B2 over {MESH_B2_SHARDS} shards of "
          f"{N // MESH_B2_SHARDS} rows (M={M} K={K} F={F} C={C} k={Q}): "
          f"linear_mc launched {launches} times for one sharded select; "
          f"each shard's kernel vs its plain version max |err| {worst:.3e} "
          f"(<= {SPLIT_MAX_ERR}); merged top-k vs one unsharded launch: "
          f"values within the gate, {split} slots split by near-ties; "
          f"CUDA-event median of {REPS}: sharded {sharded_ms:.4f} ms "
          f"({MESH_B2_SHARDS} shards, one after another, one card), "
          f"unsharded {single_ms:.4f} ms")

    # (b) the six fused modes, bit for bit
    mesh2 = make_pool_mesh(["cuda:0"] * MESH_STEP_SHARDS)
    devs = mesh2.device_list
    sharded = pool_mesh.make_sharded_step_fns(mesh2, k=Q)
    plain_fns = make_scoring_fns(k=Q)
    probs, qbdc = tables["members"]["cuda"], tables["qbdc"]["cuda"]
    hc_t = torch.from_numpy(hc).cuda()
    hc_ent = shannon_entropy(hc_t)
    weights = torch.from_numpy(np.random.default_rng(SEED + 30).uniform(
        0.05, 1.0, probs.shape[0]).astype(np.float32)).cuda()
    table_of = {"qbdc_fused": qbdc}
    compared = 0
    for key in scoring.FUSED_MASKS:
        pool_u, hc_u = mt.clone(), torch.ones_like(mt)
        pool_s = ShardedRows.split(pool_u, devs, 0)
        hc_s = ShardedRows.split(hc_u, devs, 0)
        p = table_of.get(key, probs)
        p_s = ShardedRows.split(p, devs, 1)
        for it in range(MESH_ITERS):
            key_it = prng.key(SEED + 50 + it, "cpu")
            args = {"mc_fused": ((p_s, pool_s), (p, pool_u)),
                    "qbdc_fused": ((p_s, pool_s), (p, pool_u)),
                    "wmc_fused": ((p_s, pool_s, weights),
                                  (p, pool_u, weights)),
                    "rand_fused": ((key_it, pool_s), (key_it, pool_u)),
                    "hc_pre_fused": ((hc_ent, hc_s, pool_s),
                                     (hc_ent, hc_u, pool_u)),
                    "mix_fused": ((p_s, pool_s, hc_t, hc_s),
                                  (p, pool_u, hc_t, hc_u))}[key]
            a = sharded[key](*args[0])
            r = plain_fns[key](*args[1])
            ent = a.entropy.full() if isinstance(a.entropy, ShardedRows) \
                else a.entropy
            same = (torch.equal(ent, r.entropy)
                    and torch.equal(a.values, r.values)
                    and torch.equal(a.indices, r.indices)
                    and torch.equal(pool_s.full(), pool_u)
                    and torch.equal(hc_s.full(), hc_u))
            if not same or valid_count(a.values) != Q:
                raise AssertionError(f"mesh (b) {key} select {it}: sharded "
                                     "and unsharded steps differ")
            compared += 1
    print(f"[mesh] (b) the six fused modes over {MESH_STEP_SHARDS} shards "
          f"of phases 7-9's N={N} tables (members, qbdc K={QBDC_K}, hc), "
          f"{MESH_ITERS} selects each ({compared} in all): entropies, "
          f"values, ids and pool/hc masks bit-equal to the unsharded steps "
          f"on the card")

    # (c) sequence parallelism at full width
    cfg = CNNConfig(arch="harm")
    members = [CNNMember(f"harm.it_{i}", short_cnn.init_variables(
        prng.key(SEED + 60 + i, "cpu"), cfg, "cuda"), cfg)
        for i in range(SEQ_MEMBERS)]
    com = Committee([], members, cfg, full_song_hop=cfg.input_length,
                    device="cuda")
    wave = (np.random.default_rng(SEED + 61).standard_normal(
        SEQ_SONG_S * 16000) * 0.1).astype(np.float32)
    seq_mesh = make_seq_mesh(["cuda:0"] * SEQ_SHARDS)
    got_seq = com.predict_song_sequence(wave, seq_mesh)
    # the window grid as one forward of the song's windows: the committee's
    # predict_songs_cnn pads a chunk to WINDOW_CHUNK songs, 8 copies of a
    # 600-s song, more than the card holds
    song_plan = plan_windows(len(wave), SEQ_SHARDS, window=cfg.input_length)
    variables = [m.variables for m in members]

    def grid():
        return full_song_probs_reference(variables, wave, song_plan, cfg,
                                         "cuda")

    ref_seq = grid()
    np.testing.assert_allclose(got_seq.cpu().numpy(), ref_seq.cpu().numpy(),
                               err_msg="mesh (c) full song", **CNN_TOL)
    seq_err = float((got_seq - ref_seq).abs().max())
    seq_ms = time_ms(lambda: com.predict_song_sequence(wave, seq_mesh),
                     SEQ_REPS)
    grid_ms = time_ms(grid, SEQ_REPS)
    n_windows = song_plan.n_windows
    # overlapping windows: each shard copies its halo from the next one
    hop = cfg.input_length // 2
    halo_wave = wave[: SEQ_HALO_SONG_S * 16000]
    plan = plan_windows(len(halo_wave), SEQ_SHARDS, window=cfg.input_length,
                        hop=hop)
    if plan.halo <= 0:
        raise AssertionError(f"mesh (c) halo run: no halo in {plan}")
    halo_com = Committee([], members, cfg, full_song_hop=hop, device="cuda")
    halo_store = DeviceWaveformStore({0: halo_wave}, cfg.input_length,
                                     "cuda")
    got_halo = halo_com.predict_song_sequence(halo_wave, seq_mesh)
    ref_halo = halo_com.predict_songs_cnn(halo_store, [0], None)[:, 0]
    np.testing.assert_allclose(got_halo.cpu().numpy(),
                               ref_halo.cpu().numpy(),
                               err_msg="mesh (c) halo", **CNN_TOL)
    halo_err = float((got_halo - ref_halo).abs().max())
    del com, halo_com, members, variables, halo_store
    torch.cuda.empty_cache()
    print(f"[mesh] (c) one {SEQ_SONG_S}-s song ({len(wave)} samples, "
          f"{n_windows} windows of {cfg.input_length}), {SEQ_MEMBERS} harm "
          f"members at full width: predict_song_sequence over {SEQ_SHARDS} "
          f"seq shards vs the window grid in one forward within "
          f"{CNN_TOL} (max |diff| {seq_err:.3e}); CUDA-event median of "
          f"{SEQ_REPS}: {seq_ms:.3f} ms a song sharded ({SEQ_SHARDS} shards, "
          f"one after another, one card), {grid_ms:.3f} ms on the grid; "
          f"its first {SEQ_HALO_SONG_S} s at hop {hop} ({plan.n_windows} "
          f"windows, a {plan.halo}-sample halo copied from each right "
          f"neighbour's shard) vs the committee's window-grid "
          f"predict_songs_cnn within the gate (max |diff| "
          f"{halo_err:.3e})")

    # (d) the CLI with a mesh (run inside phase 11)
    print(f"[mesh] (d) amg_test {' '.join(CLI_CNN_ARGS)} -m mc with phase "
          f"11's GBDT + vgg registry: queried songs equal phase 11's "
          f"unmeshed card run every epoch for " + "; ".join(
              f"{k} ({mesh_cli['walls'][k]:.1f} s, max |F1 diff| "
              f"{mesh_cli['f1_diff'][k]:.3e})" for k in mesh_cli["walls"])
          + f"; --mesh 2 on one card: {mesh_cli['refused']!r}; linear_mc "
          f"launches 0")
    return {"launches": launches, "max_abs_err": worst,
            "sharded_ms": sharded_ms, "single_ms": single_ms}


# -- slice 10: single-host serving -----------------------------------------


def serve_inputs():
    """Phase 19's trace (SERVE_USERS seeded Poisson arrivals compressed
    into SERVE_TRACE_S s, two classes, pools skewed over SERVE_POOLS) and
    each user's data and REG_MEMBERS GaussianNB + REG_MEMBERS SGD members,
    all from seeds: the drill's subprocess rebuilds the same ones."""
    trace = generate(TraceSpec(
        seed=SERVE_TRACE_SEED, n_users=SERVE_USERS, rate=4.0,
        class_mix=(("interactive", 0.5), ("batch", 0.5)), pool_dist="skew",
        pool_sizes=SERVE_POOLS, horizon_s=SERVE_TRACE_S))
    ids = list(range(1, FULL_SONGS + 1))
    users = {}
    for i, ev in enumerate(e for e in trace.events if e["kind"] == "arrive"):
        pool, labels, centers = full_user(ids, seed=SEED + 70 + i,
                                          n_songs=ev["pool"])
        users[ev["user"]] = (UserData(ev["user"], pool, labels),
                             fit_members(centers, REG_MEMBERS,
                                         SEED + 80 + 10 * i))
    return trace, users


def serve_config():
    return ALConfig(queries=Q, epochs=SERVE_EPOCHS, mode="mc",
                    train_size=TRAIN_SIZE, seed=SEED, ckpt_dtype="float32")


def serve_trace_run(root, trace, users):
    """The trace through ``FleetServer(target_live=SERVE_LIVE)`` on the
    card, its journal, metrics and spans under ``root/users``: played by
    ``TraceDriver(ServerTarget)`` on a fresh journal; on a journal a
    killed run left, restarted as the CLI restarts (the journal's
    recovery order).  Returns wall s, the driver's stats, the summary."""
    users_dir = os.path.join(root, "users")
    os.makedirs(users_dir, exist_ok=True)
    report = FleetReport(os.path.join(users_dir, "fleet_metrics.jsonl"))
    journal = AdmissionJournal(os.path.join(users_dir,
                                            "serve_journal.jsonl"))
    tracer = Tracer(os.path.join(users_dir, "spans.jsonl"),
                    run_id=f"mc-{SEED}")
    sched = FleetScheduler(serve_config(), report=report,
                           scoring_by_width=True,
                           host_workers=FLEET_HOST_WORKERS, device="cuda",
                           tracer=tracer)
    server = FleetServer(sched, ServeConfig(target_live=SERVE_LIVE),
                         journal=journal)

    def build_entry(uid, cls, pool):
        path = os.path.join(users_dir, uid)
        os.makedirs(path, exist_ok=True)
        data, members = users[uid]
        committee = (workspace.load_committee(path) if os.path.exists(
            os.path.join(path, al_state.STATE_FILE))
            else Committee(copy.deepcopy(members)))
        return FleetUser(uid, committee, data, path, seed=SEED,
                         committee_factory=lambda p=path:
                         workspace.load_committee(p), priority=cls)

    stats = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        if journal.recovered:
            arrive = {e["user"]: e for e in trace.events
                      if e["kind"] == "arrive"}
            order = journal.state.recovery_order(trace.users)
            server.serve(build_entry(u, arrive[u]["cls"], arrive[u]["pool"])
                         for u in order)
        else:
            driver = TraceDriver(trace, ServerTarget(server, build_entry))
            driver.start()
            try:
                server.serve((), keep_open=True)
            finally:
                driver.stop()
                if not driver.join(timeout=60):
                    raise AssertionError("serve: the trace driver hung")
            stats = driver.stats.as_dict()
    finally:
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tracer.close()
        summary = report.write_summary(cohort=SERVE_LIVE, wall_s=wall)
        report.close()
        journal.close()
    return {"wall": wall, "stats": stats, "summary": summary,
            "users_dir": users_dir}


def serve_drill_main(root):
    """``chip_smoke.py --serve-drill ROOT``: phase 19 (b)'s subprocess, one
    run of the trace under ROOT (killed by ``CETPU_FAULTS`` when set).  An
    injected kill is process death on whichever thread it fires: on the
    trace driver's (an enqueue's journal append) the process exits at
    once, as a SIGKILL would end it."""
    import threading
    import traceback

    from consensus_entropy_tpu_torch.resilience import faults

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")

    def die(args):
        if issubclass(args.exc_type, faults.InjectedKill):
            traceback.print_exception(args.exc_type, args.exc_value,
                                      args.exc_traceback)
            sys.stderr.flush()
            os._exit(1)
        threading.__excepthook__(args)

    threading.excepthook = die
    trace, users = serve_inputs()
    serve_trace_run(root, trace, users)


def serve_run_check(run, trace, ref_paths, what):
    """Each user's metrics and state equal ``ref_paths``'s, the grader
    finds no loss and a clean journal and stream, the spans no orphans."""
    users_dir = run["users_dir"]
    paths = [os.path.join(users_dir, u) for u in trace.users]
    _same_runs(paths, ref_paths, what)
    jpath = os.path.join(users_dir, "serve_journal.jsonl")
    grade = grade_run(users_dir, journal_path=jpath, trace=trace,
                      slo_s={"interactive": 60.0, "batch": 600.0},
                      wall_s=run["wall"], driver_stats=run["stats"])
    det = grade["deterministic"]
    if not (det["zero_loss"] and det["stream_ok"] and det["journal_ok"]):
        raise AssertionError(f"{what}: grade {det} "
                             f"{grade['measured']['stream_errors']} "
                             f"{grade['measured']['journal_errors']}")
    errors = validate_metrics_file(os.path.join(users_dir,
                                                "fleet_metrics.jsonl"))
    if errors:
        raise AssertionError(f"{what}: metrics stream {errors[:3]}")
    spans = load_spans(find_span_files(users_dir))
    orphans = orphan_spans(spans)
    events = chrome_trace(spans)["traceEvents"]
    if not spans or orphans or not events:
        raise AssertionError(f"{what}: {len(spans)} spans, "
                             f"{len(orphans)} orphans")
    return grade, spans


def phase_serve(card, serve_cli):
    """Phase 19: single-host serving on the card, (a)-(c)."""
    trace, users = serve_inputs()
    cfg = serve_config()
    with tempfile.TemporaryDirectory() as root:
        seq_paths, seq_wall = [], 0.0
        for uid in trace.users:
            data, members = users[uid]
            path = os.path.join(root, "seq", uid)
            os.makedirs(path)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ALLoop(cfg, device="cuda").run_user(
                Committee(copy.deepcopy(members)), data, path)
            torch.cuda.synchronize()
            seq_wall += time.perf_counter() - t0
            seq_paths.append(path)
        # (a) the trace through the server
        linear_mc.launches = 0
        run = serve_trace_run(os.path.join(root, "a"), trace, users)
        launches = linear_mc.launches
        if launches:
            raise AssertionError(f"serve: {launches} linear_mc launches")
        grade, spans = serve_run_check(run, trace, seq_paths, "serve (a)")
        # phase 21 (d): soak gen / digest / grade against this run
        before = linear_mc.launches
        soak = soak_checks(root, trace, run, grade)
        soak["launches"] = linear_mc.launches - before
        s = run["summary"]
        widths = sorted(s.get("per_bucket") or {})
        if len(widths) < 2 or s.get("dispatch_failures"):
            raise AssertionError(f"serve (a): buckets {widths}, summary {s}")
        occ = [b["occupancy"] for b in s["per_bucket"].values()
               if b["occupancy"] is not None]
        lat = {c: v["admission_to_finish_s"]
               for c, v in (s.get("per_class") or {}).items()}
        waits = {c: [e["wait_s"] for e in read_jsonl_tolerant(os.path.join(
            run["users_dir"], "fleet_metrics.jsonl"))
            if e.get("event") == "admit" and e.get("cls") == c]
            for c in lat}
        print(f"[serve] {card}: (a) a {SERVE_USERS}-user trace (seed "
              f"{SERVE_TRACE_SEED}, Poisson arrivals in {SERVE_TRACE_S} s, "
              f"pools {[e['pool'] for e in trace.events]}, classes "
              f"{grade['deterministic']['class_counts']}) played by "
              f"TraceDriver into FleetServer(target_live={SERVE_LIVE}), SLO "
              f"planner, journal and tracer on, {REG_MEMBERS} GaussianNB + "
              f"{REG_MEMBERS} SGD members, mc, {SERVE_EPOCHS} iterations: "
              f"each user's metrics and al_state.json equal its sequential "
              f"run's on the card; grade_run: lost users "
              f"{grade['deterministic']['lost_users']}, stream and journal "
              f"clean; validate_metrics clean; {len(spans)} spans, 0 orphans,"
              f" chrome_trace exported; linear_mc launches {launches}")
        print(f"[serve] {card}: (a) host clock: admission wait by class "
              + ", ".join(f"{c} p50 {percentile(w, 50):.4f} s p95 "
                          f"{percentile(w, 95):.4f} s"
                          for c, w in sorted(waits.items()))
              + "; admission-to-finish by class " + ", ".join(
                  f"{c} p50 {v['p50']} s p95 {v['p95']} s"
                  for c, v in sorted(lat.items()))
              + f"; buckets {widths}, mean bucket occupancy "
              f"{statistics.mean(occ):.3f} ({s['per_bucket']}); planner "
              f"{s.get('planner')}; users/s served "
              f"{SERVE_USERS / run['wall']:.4f} ({run['wall']:.2f} s, the "
              f"trace's {SERVE_TRACE_S} s of arrivals included) vs "
              f"sequential {SERVE_USERS / seq_wall:.4f} ({seq_wall:.2f} s)")
        # (b) the crash drill: killed mid-run in a subprocess, restarted
        here = os.path.dirname(os.path.abspath(__file__))
        drill = os.path.join(root, "b")
        cmd = [sys.executable, os.path.join(here, "chip_smoke.py"),
               "--serve-drill", drill]
        env = dict(os.environ, PYTHONPATH=here,
                   CETPU_FAULTS=f"serve.journal.append:kill@{SERVE_KILL_AT}")
        t0 = time.perf_counter()
        killed = subprocess.run(cmd, cwd=here, env=env, timeout=600,
                                capture_output=True, text=True)
        if killed.returncode == 0 or "injected kill" not in killed.stderr:
            raise AssertionError(f"serve (b): the drill did not kill (exit "
                                 f"{killed.returncode}):\n"
                                 f"{killed.stderr[-2000:]}")
        jpath = os.path.join(drill, "users", "serve_journal.jsonl")
        st = AdmissionJournal(jpath).state
        finished, in_flight = set(st.finished), list(st.in_flight)
        if not finished or len(finished) == SERVE_USERS:
            raise AssertionError(f"serve (b): the kill at append "
                                 f"{SERVE_KILL_AT} was not mid-run: "
                                 f"{sorted(finished)} finished")
        env.pop("CETPU_FAULTS")
        rerun = subprocess.run(cmd, cwd=here, env=env, timeout=600,
                               capture_output=True, text=True)
        if rerun.returncode != 0:
            raise AssertionError(f"serve (b): the restart exited "
                                 f"{rerun.returncode}:\n"
                                 f"{rerun.stderr[-2000:]}")
        drill_s = time.perf_counter() - t0
        with open(os.path.join(drill, "users", "fleet_metrics.jsonl")) as f:
            restart = [json.loads(line) for line in f]
        skipped = {e["user"] for e in restart if e["event"] == "skip_done"}
        if skipped != finished:
            raise AssertionError(f"serve (b): skipped {sorted(skipped)}, "
                                 f"finished before the kill "
                                 f"{sorted(finished)}")
        a_paths = [os.path.join(run["users_dir"], u) for u in trace.users]
        grade_b, _ = serve_run_check(
            {"users_dir": os.path.join(drill, "users"), "wall": None,
             "stats": None}, trace, a_paths, "serve (b)")
    print(f"[serve] {card}: (b) the trace killed in a subprocess at "
          f"serve.journal.append hit {SERVE_KILL_AT} ({len(finished)} users "
          f"finished, {len(in_flight)} in flight), restarted from the "
          f"journal: lost users {grade_b['deterministic']['lost_users']}, "
          f"the {len(skipped)} finished users skipped, every user's metrics "
          f"and state equal (a)'s; {drill_s:.1f} s for both processes")
    print(f"[serve] {card}: (c) amg_test {' '.join(serve_cli['args'])} "
          f"--serve 2 on phase 11's GBDT + vgg registry: queried songs equal"
          f" the sequential CLI's every epoch (max |F1 diff| "
          f"{serve_cli['f1_diff']:.3e}); spans {serve_cli['spans']}, 0 "
          f"orphans; torch.profiler trace of the first "
          f"{SERVE_PROFILE_N} dispatches with {serve_cli['kernels']} CUDA "
          f"kernel events; {serve_cli['wall_s']:.1f} s")
    return {"launches": launches, "soak": soak}


def serve_cli_runs(root, amg_root, cnn):
    """Phase 19 (c), on phase 11's tree: ``amg_test --serve 2`` with the
    vgg registry (SERVE_CLI_ARGS: two users) and ``--trace-dir``,
    ``--torch-profile``, against the sequential CLI on the same two users;
    the queried songs equal every epoch, the spans have no orphans, the
    profile holds CUDA kernel events."""
    t_all = time.perf_counter()
    runs, walls = {}, {}
    spans_dir = os.path.join(root, "serve_spans")
    prof_dir = os.path.join(root, "serve_prof")
    for name, extra in (("seq", []), ("serve", [
            "--serve", "2", "--bucket-widths", SERVE_CLI_WIDTHS,
            "--trace-dir", spans_dir, "--torch-profile", prof_dir,
            "--torch-profile-n", str(SERVE_PROFILE_N)])):
        models = os.path.join(root, f"models_serve_{name}")
        shutil.copytree(os.path.join(cnn["bases"]["vgg"], "pretrained"),
                        os.path.join(models, "pretrained"))
        linear_mc.launches = 0
        t0 = time.perf_counter()
        text = run_cli(SERVE_CLI_ARGS + [
            "-m", "mc", "--models-root", models, "--amg-root", amg_root,
            "--device", "cuda", "--cnn-config-json", json.dumps(CLI_CNN)]
            + extra)
        walls[name] = time.perf_counter() - t0
        if linear_mc.launches:
            raise AssertionError(f"serve-cli {name}: linear_mc launched")
        users = os.path.join(models, "users")
        runs[name] = {u: read_metrics(os.path.join(users, u, "mc"))
                      for u in sorted(os.listdir(users))
                      if os.path.isdir(os.path.join(users, u, "mc"))}
    if "serve summary: " not in text or len(runs["serve"]) != 2 \
            or sorted(runs["serve"]) != sorted(runs["seq"]):
        raise AssertionError(f"serve-cli: users {sorted(runs['serve'])}:\n"
                             f"{text[-2000:]}")
    f1_diff = 0.0
    for u, ref in runs["seq"].items():
        got = runs["serve"][u]
        if sorted(got) != sorted(ref):
            raise AssertionError(f"serve-cli user {u}: epochs {sorted(got)}")
        for e in ref:
            if got[e].get("queried") != ref[e].get("queried"):
                raise AssertionError(f"serve-cli user {u} epoch {e}: "
                                     "queried songs differ")
            f1_diff = max(f1_diff, float(np.max(np.abs(np.subtract(
                got[e]["f1"], ref[e]["f1"])))))
    spans = load_spans(find_span_files(spans_dir))
    if not spans or orphan_spans(spans):
        raise AssertionError(f"serve-cli: {len(spans)} spans, "
                             f"{len(orphan_spans(spans))} orphans")
    (prof,) = os.listdir(prof_dir)
    with open(os.path.join(prof_dir, prof)) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if not kernels:
        raise AssertionError("serve-cli: the device profile holds no CUDA "
                             "kernel events")
    return {"args": SERVE_CLI_ARGS, "f1_diff": f1_diff, "spans": len(spans),
            "kernels": kernels, "wall_s": time.perf_counter() - t_all,
            "serve_wall_s": walls["serve"], "users": len(runs["serve"])}


# -- slice 11: the multi-host serve fabric ---------------------------------


#: ``sitecustomize`` put on the fabric processes' path: each launch of the
#: ``linear_mc`` kernel in any of them appends a line to the file named by
#: CHIP_SMOKE_LAUNCH_LOG, so a worker killed mid-run still leaves its count
LAUNCH_HOOK = """\
import os as _os
_log = _os.environ.get("CHIP_SMOKE_LAUNCH_LOG")
if _log:
    from consensus_entropy_tpu_torch.kernels import linear_mc as _lm
    _launch = _lm._launch

    def _counted(*args, **kwargs):
        out = _launch(*args, **kwargs)
        with open(_log, "a") as _f:
            _f.write(f"{_os.getpid()}\\n")
        return out

    _lm._launch = _counted
"""


def _proc_start_wall(pid):
    """Wall-clock seconds at which process ``pid`` started (``/proc``), or
    None once it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
    except (OSError, StopIteration, ValueError, IndexError):
        return None
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def _gpu_memory_used():
    """The card's ``memory.used`` in MiB from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=10).stdout.split()
    except (OSError, subprocess.SubprocessError):
        return None
    return int(out[0]) if out and out[0].isdigit() else None


class FabricWatch:
    """Follows one ``amg_test --hosts`` run from outside: the main
    journal's records (with the wall time each was seen), every worker's
    lease beats and pid, the card's memory in use (``nvidia-smi`` lists
    no process inside the card machine's container, so no per-process
    figure); ``on_poll(self)`` may act (the drills' SIGKILL).  Kills the coordinator and every worker it saw on
    the way out, so no process outlives the phase."""

    def __init__(self, users_dir):
        from consensus_entropy_tpu_torch.serve.journal import JsonlTail

        self.users_dir = users_dir
        self.fabric_dir = os.path.join(users_dir, "fabric")
        self.tail = JsonlTail(os.path.join(users_dir,
                                           "serve_journal.jsonl"))
        self.records = []
        self.beats = {}      # host -> {beat: t}
        self.pids = {}       # host -> set of pids
        self.started = {}    # pid -> wall start
        #: the card's memory.used before the run and its peak during it
        self.used_before = self.used_peak = None
        self._mem_t = 0.0
        self.runs = 0

    def last(self):
        """``{user: (last event, host it is assigned to)}``."""
        out, host = {}, {}
        for r in self.records:
            u = r.get("user")
            if u is None:
                continue
            if r["event"] == "assign":
                host[u] = r.get("host")
            if r["event"] in ("enqueue", "admit", "finish", "fail",
                              "poison"):
                out[u] = r["event"]
        return {u: (e, host.get(u)) for u, e in out.items()}

    def poll(self):
        now = time.time()
        for rec, _ in self.tail.poll():
            self.records.append(dict(rec, seen=now))
        if os.path.isdir(self.fabric_dir):
            for name in os.listdir(self.fabric_dir):
                if not (name.startswith("lease_") and name.endswith(".json")):
                    continue
                try:
                    with open(os.path.join(self.fabric_dir, name)) as f:
                        lease = json.load(f)
                except (OSError, ValueError):
                    continue  # mid-rename
                h, pid = lease["host"], int(lease["pid"])
                self.beats.setdefault(h, {})[lease["beat"]] = lease["t"]
                if pid not in self.pids.setdefault(h, set()):
                    self.pids[h].add(pid)
                    self.started[pid] = _proc_start_wall(pid)
        if now - self._mem_t > 1.0:
            self._mem_t = now
            used = _gpu_memory_used()
            if used is not None:
                self.used_peak = max(used, self.used_peak or used)

    def run(self, cmd, env, on_poll=None, timeout=FABRIC_TIMEOUT_S):
        """Run the coordinator ``cmd`` to its end; returns (exit code, its
        output, wall s)."""
        self.runs += 1
        log = os.path.join(os.path.dirname(self.users_dir),
                           f"coordinator_{self.runs}.log")
        here = os.path.dirname(os.path.abspath(__file__))
        if self.used_before is None:
            self.used_before = _gpu_memory_used()
        t0 = time.perf_counter()
        with open(log, "wb") as out:
            proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=out,
                                    stderr=subprocess.STDOUT)
            try:
                while proc.poll() is None:
                    if time.perf_counter() - t0 > timeout:
                        raise AssertionError(f"fabric: {cmd[-12:]} ran past "
                                             f"{timeout} s")
                    self.poll()
                    if on_poll is not None:
                        on_poll(self)
                    time.sleep(0.02)
                self.poll()
            finally:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
                self.kill_workers()
        wall = time.perf_counter() - t0
        with open(log, errors="replace") as f:
            return proc.returncode, f.read(), wall

    def kill_workers(self):
        for pids in self.pids.values():
            for pid in pids:
                if _pid_alive(pid):
                    with contextlib.suppress(OSError):
                        os.kill(pid, 9)

    def lease_pid(self, host):
        with open(os.path.join(self.fabric_dir, f"lease_{host}.json")) as f:
            return int(json.load(f)["pid"])

    def host_stats(self):
        """Per host: spawn to first lease (s) and the largest beat gap
        (s)."""
        out = {}
        for h, beats in sorted(self.beats.items()):
            ts = [beats[b] for b in sorted(beats)]
            gaps = [b - a for a, b in zip(ts, ts[1:])]
            pids = sorted(self.pids.get(h, ()))
            starts = [self.started.get(p) for p in pids]
            first = beats[min(beats)]
            out[h] = {
                "spawn_to_lease_s": (round(first - starts[0], 3)
                                     if starts and starts[0] else None),
                "first_beat": min(beats),
                "max_gap_s": round(max(gaps), 3) if gaps else None}
        return out

    def finish_counts(self):
        counts = {}
        for r in self.records:
            if r["event"] == "finish":
                counts[r["user"]] = counts.get(r["user"], 0) + 1
        return counts


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    with contextlib.suppress(OSError):
        with open(f"/proc/{pid}/stat") as f:
            if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                return False
    return True


def fabric_env(root, launch_log, faults_spec=None):
    """The coordinator's environment: the repo and the launch hook (written
    by ``fabric_cli_runs``) on the path, the launch log named,
    CETPU_FAULTS set or cleared."""
    here = os.path.dirname(os.path.abspath(__file__))
    hook = os.path.join(root, "launch_hook")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([hook, here]),
               CHIP_SMOKE_LAUNCH_LOG=launch_log)
    env.pop("CETPU_FAULTS", None)
    if faults_spec:
        env["CETPU_FAULTS"] = faults_spec
    return env


def _users_runs(models, mode="mc"):
    users = os.path.join(models, "users")
    return {u: os.path.join(users, u, mode) for u in sorted(os.listdir(users))
            if os.path.isdir(os.path.join(users, u, mode))}


def _queried_match(paths, refs, what):
    """Phase 19 (c)'s check of CNN-member runs made in other processes:
    each user's queried songs equal the reference's every epoch.  Returns
    the largest |F1 difference| and the (user, epoch) pairs where an F1
    differs (cuDNN picks its algorithms anew in each process)."""
    diff, where = 0.0, []
    for u in sorted(refs):
        m, r = read_metrics(paths[u]), read_metrics(refs[u])
        if sorted(m) != sorted(r):
            raise AssertionError(f"{what} user {u}: epochs {sorted(m)}")
        for e in r:
            if m[e].get("queried") != r[e].get("queried"):
                raise AssertionError(f"{what} user {u} epoch {e}: queried "
                                     "songs differ")
            d = float(np.max(np.abs(np.subtract(m[e]["f1"], r[e]["f1"]))))
            if d:
                where.append((u, e))
            diff = max(diff, d)
    return diff, where


def _timeline(watch):
    """The journal's records as (event, host, user, s since the first)."""
    t0 = watch.records[0]["t"] if watch.records else 0.0
    return [(r["event"], r.get("host"), r.get("user"), round(r["t"] - t0, 2))
            for r in watch.records]


def _fabric_check(watch, users, what, orphans_ok=False):
    """Every user finished with exactly one ``finish`` record, the
    journal validates (port validator), the merged spans have no orphans
    (``orphans_ok``: counted only; a session released at a fence never
    ends the iteration span its host steps name, in the JAX package as
    here).  Returns (spans, orphans)."""
    from consensus_entropy_tpu_torch.serve import validate_journal_file

    counts = watch.finish_counts()
    if sorted(counts) != sorted(users) or set(counts.values()) != {1}:
        raise AssertionError(f"{what}: finish records {counts}, users "
                             f"{sorted(users)}")
    jerr = validate_journal_file(os.path.join(watch.users_dir,
                                              "serve_journal.jsonl"))
    spans = load_spans([os.path.join(watch.users_dir, "spans.jsonl")])
    orphans = len(orphan_spans(spans))
    if jerr or not spans or (orphans and not orphans_ok):
        raise AssertionError(f"{what}: journal {jerr[:3]}, {len(spans)} "
                             f"spans, {orphans} orphans")
    return len(spans), orphans


class Job:
    """``fn()`` on a thread of its own; ``result`` waits for it and returns
    what it returned or raises what it raised."""

    def __init__(self, fn):
        self.out = self.error = None
        self.thread = threading.Thread(target=self._run, args=(fn,),
                                       daemon=True)
        self.thread.start()

    def _run(self, fn):
        try:
            self.out = fn()
        except BaseException as e:  # re-raised by result()
            self.error = e

    def result(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.out


def kill_h1_mid_run(kill):
    """The drills' ``on_poll``: SIGKILL h1 once it holds one finished and
    one in-flight user, noting when, its pid and the users it held in
    ``kill``."""

    def on_poll(watch):
        if kill:
            return
        on_h1 = {u: e for u, (e, h) in watch.last().items() if h == "h1"}
        if "finish" in on_h1.values() and "admit" in on_h1.values():
            pid = watch.lease_pid("h1")
            os.kill(pid, 9)
            kill.update(t=time.time(), pid=pid,
                        moved=[u for u, e in on_h1.items() if e == "admit"])

    return on_poll


def fabric_cli_runs(root, amg_root, cnn, host_models, meanwhile):
    """Phase 20, on phase 11's tree (run inside phase 11): ``amg_test
    --serve 1 --hosts 2`` as a subprocess on the card, (a) a worker
    SIGKILLed mid-run, (b) the coordinator killed and restarted, (c) the
    elastic fleet's scale-up and fenced scale-down.  The runs are waited
    on from threads: (a) beside the sequential references in this
    process, (b) and (c) beside ``meanwhile()``.  Returns phase 20's
    results and what ``meanwhile()`` returned."""
    t_all = time.perf_counter()
    launch_log = os.path.join(root, "fabric_launches.log")
    open(launch_log, "w").close()
    os.makedirs(os.path.join(root, "launch_hook"))
    with open(os.path.join(root, "launch_hook", "sitecustomize.py"),
              "w") as f:
        f.write(LAUNCH_HOOK)
    cmd = [sys.executable, "-m", "consensus_entropy_tpu_torch.cli.amg_test"]
    cnn_flags = ["--cnn-config-json", json.dumps(CLI_CNN)]

    def models_for(name, base):
        models = os.path.join(root, f"models_fabric_{name}")
        shutil.copytree(os.path.join(base, "pretrained"),
                        os.path.join(models, "pretrained"))
        return models

    def flags(models, tree, args):
        return args + ["-m", "mc", "--models-root", models, "--amg-root",
                       tree, "--device", FABRIC_DEVICE]

    fabric_args = FABRIC_ARGS + ["--serve", "1", "--hosts", "2",
                                 "--placement", "load"]

    # (a) h1 SIGKILLed once it holds one finished and one in-flight user;
    # phase 21 (a): the operator's view of the same run
    kill = {}
    a_models = models_for("a", cnn["bases"]["vgg"])
    a = FabricWatch(os.path.join(a_models, "users"))
    poll = StatusPoll(a.users_dir).start()

    def run_a():
        try:
            return a.run(cmd + flags(a_models, amg_root, fabric_args)
                         + cnn_flags, fabric_env(root, launch_log),
                         kill_h1_mid_run(kill))
        finally:
            poll.stop(not_before=kill.get("t", 0) + STATUS_STALE_S + 1)

    a_job = Job(run_a)
    try:
        # the sequential references, in this process on the card; their
        # launches are this process's share of phase 20's
        inproc = linear_mc.launches
        seq = models_for("seq", cnn["bases"]["vgg"])
        t0 = time.perf_counter()
        run_cli(flags(seq, amg_root, FABRIC_ARGS) + cnn_flags)
        seq_wall = time.perf_counter() - t0
        # (c)'s tree and sequential runs
        c_tree = write_amg_tree(os.path.join(root, "fabric_c"),
                                users=FABRIC_C_USERS,
                                feats_from=os.path.join(amg_root, "feats"))
        c_seq = models_for("c_seq", host_models)
        run_cli(flags(c_seq, c_tree, FABRIC_C_ARGS))
        inproc = linear_mc.launches - inproc
    finally:
        a_job.thread.join()
    rc, out, a_wall = a_job.result()
    seq_paths = _users_runs(seq)
    users = sorted(seq_paths)
    if len(users) != FABRIC_USERS:
        raise AssertionError(f"fabric: sequential users {users}")
    if rc != 0 or "fabric summary: " not in out or not kill:
        raise AssertionError(f"fabric (a): exit {rc}, kill {kill}:\n"
                             f"{out[-3000:]}")
    n_spans, _ = _fabric_check(a, users, "fabric (a)")
    a_paths = _users_runs(a_models)
    f1_a = _queried_match(a_paths, seq_paths, "fabric (a)")
    revoke = [r for r in a.records if r["event"] == "revoke"
              and r.get("host") == "h1"]
    readmit = [r for r in a.records if r["event"] == "admit"
               and r.get("user") in kill["moved"] and r.get("host") != "h1"]
    if len(revoke) != 1 or not readmit:
        raise AssertionError(f"fabric (a): revoke {revoke}, re-admission "
                             f"{readmit}")
    a_stats, a_kill = a.host_stats(), dict(kill)
    a_mem = (None if a.used_peak is None or a.used_before is None
             else a.used_peak - a.used_before)
    status = status_check(poll, a_kill["t"], a.users_dir)

    # (b) the same run killed at the failover's fabric.assign, restarted;
    # (c) beside it: its host-member processes use little of the card, and
    # (b) times nothing
    c_models = models_for("c", host_models)
    b_models = models_for("b", cnn["bases"]["vgg"])

    def run_b():
        b = FabricWatch(os.path.join(b_models, "users"))
        kill_b = {}
        rc, out, _ = b.run(cmd + flags(b_models, amg_root, fabric_args)
                           + cnn_flags, fabric_env(
                               root, launch_log,
                               f"fabric.assign:kill@{FABRIC_USERS + 1}"),
                           kill_h1_mid_run(kill_b))
        if rc == 0 or "injected kill" not in out or not kill_b:
            raise AssertionError(f"fabric (b): exit {rc}, kill {kill_b}:\n"
                                 f"{out[-3000:]}")
        done_before = sorted(u for u, (e, _) in b.last().items()
                             if e == "finish")
        if not done_before or len(done_before) == FABRIC_USERS:
            raise AssertionError(f"fabric (b): the kill was not mid-run: "
                                 f"{done_before} finished")
        old_pids = {p for pids in b.pids.values() for p in pids}
        orphans = sorted(p for p in old_pids if _pid_alive(p))
        rc, out, _ = b.run(cmd + flags(b_models, amg_root, fabric_args)
                           + cnn_flags, fabric_env(root, launch_log))
        if rc != 0 or "fabric summary: " not in out:
            raise AssertionError(f"fabric (b) restart: exit {rc}:\n"
                                 f"{out[-3000:]}")
        if any(_pid_alive(p) for p in old_pids):
            raise AssertionError("fabric (b): a worker of the killed run "
                                 "outlived the restart")
        _fabric_check(b, users, "fabric (b)")
        skipped = sum(1 for e in read_jsonl_tolerant(os.path.join(
            b.users_dir, "fleet_metrics.jsonl"))
            if e.get("event") == "skip_done")
        return {"b_done_before": done_before, "b_orphans": orphans,
                "b_skipped": skipped, "f1_b": _queried_match(
                    _users_runs(b_models), a_paths, "fabric (b)")}

    jobs = [Job(run_b), Job(lambda: fabric_elastic_run(
        cmd + flags(c_models, c_tree, FABRIC_C_ARGS), _users_runs(c_seq),
        c_models, launch_log, root))]
    try:
        side = meanwhile()
    finally:
        for job in jobs:
            job.thread.join()
    b_res, c_res = (job.result() for job in jobs)
    # phase 21 (c), (d): fsck and report over the runs' directories
    before = linear_mc.launches
    fsck = fsck_checks(root, a.users_dir, os.path.join(c_models, "users"))
    report = report_check(root, a.users_dir)
    ops_launches = linear_mc.launches - before
    with open(launch_log) as f:
        launches = sum(1 for _ in f) + inproc
    return {
        "wall_s": time.perf_counter() - t_all, "seq_wall": seq_wall,
        "a_wall": a_wall, "a_stats": a_stats, "f1_a": f1_a,
        "moved_users": a_kill["moved"], "a_mem": a_mem,
        "kill_to_revoke_s": revoke[0]["t"] - a_kill["t"],
        "revoke_to_readmit_s": readmit[0]["t"] - revoke[0]["t"],
        "moved": len(a_kill["moved"]), "spans": n_spans,
        "launches": launches, "status": status,
        "fsck": fsck, "report": report, "ops_launches": ops_launches,
        **b_res, **c_res}, side


def fabric_elastic_run(cmd, c_seq_paths, c_models, launch_log, root):
    """Phase 20 (c): FABRIC_C_USERS host-member users on phase 11's songs
    with annotators of their own (``cmd``), from 1 host to 2 under the
    backlog and back through a fenced migration; each user against its
    sequential CLI run (``c_seq_paths``)."""
    c_users = sorted(c_seq_paths)
    c = FabricWatch(os.path.join(c_models, "users"))
    sink = os.path.join(root, "fabric_c_alerts.jsonl")
    rc, out, c_wall = c.run(cmd + [
        "--serve", "1", "--hosts", "1", "--min-hosts", "1", "--max-hosts",
        "2", "--scale-down-s", str(FABRIC_SCALE_DOWN_S),
        "--alert-sink", f"jsonl:{sink}", "--priority-aging-s",
        str(FABRIC_C_AGING_S)], fabric_env(root, launch_log))
    if rc != 0 or "fabric summary: " not in out:
        raise AssertionError(f"fabric (c): exit {rc}:\n{out[-3000:]}")
    _, c_orphans = _fabric_check(c, c_users, "fabric (c)",
                                 orphans_ok=True)
    _same_runs([_users_runs(c_models)[u] for u in c_users],
               [c_seq_paths[u] for u in c_users], "fabric (c)")
    kinds = [(r["event"], r.get("host"), r.get("user")) for r in c.records]
    spawns = [r for r in c.records if r["event"] == "spawn"]
    drains = [r for r in c.records if r["event"] == "drain"]
    if [r.get("reason") for r in spawns] != ["scale_up"] or len(drains) != 1:
        raise AssertionError(f"fabric (c): {len(spawns)} spawns, "
                             f"{len(drains)} drains: {_timeline(c)}")
    victim = drains[0]["host"]
    i_drain = kinds.index(("drain", victim, None))
    fences = [(i, r) for i, r in enumerate(c.records) if i > i_drain
              and r["event"] == "fence" and r.get("host") == victim
              and r.get("ok") and isinstance(r.get("gen"), int)]
    done = [i for i, r in enumerate(c.records) if r["event"] == "drain_done"
            and r.get("host") == victim]
    if not fences or len(done) != 1:
        raise AssertionError(f"fabric (c): no fenced migration off "
                             f"{victim}: {_timeline(c)}")
    i_fence, fence = fences[0]
    moved = [i for i, r in enumerate(c.records) if i > i_fence
             and r["event"] == "assign" and r.get("user") == fence["user"]
             and r.get("host") != victim]
    if not moved or not moved[0] < done[0]:
        raise AssertionError(f"fabric (c): fence {fence}, then "
                             f"{_timeline(c)}")
    # phase 21 (b): every alert record parses, no sink failed
    recs = []
    if os.path.exists(sink):
        with open(sink) as f:
            recs = [json.loads(line) for line in f]
    snaps = read_status_dir(os.path.join(c.users_dir, "status"))
    errors = {h: s.get("alert_sink_errors") for h, s in snaps.items()}
    if "coordinator" not in snaps or set(errors.values()) != {0} \
            or not recs \
            or any(not isinstance(r.get("kind"), str) for r in recs):
        raise AssertionError(f"fabric (c) alert sink: {len(recs)} records, "
                             f"sink errors {errors}")
    kinds = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    return {"c_users": len(c_users), "c_wall": c_wall,
            "c_stats": c.host_stats(), "c_victim": victim,
            "c_fence": {"user": fence["user"], "gen": fence["gen"]},
            "c_orphans": c_orphans,
            "alerts": {"records": len(recs), "kinds": kinds,
                       "snapshots": sorted(errors)}}


def phase_fabric(card, fab, serve_cli):
    """Phase 20's lines (its runs are made inside phase 11)."""
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()

    def hosts(stats):
        return "; ".join(
            f"{h}: spawn to first lease {st['spawn_to_lease_s']} s (beat "
            f"{st['first_beat']}), largest heartbeat gap {st['max_gap_s']} s"
            " of the 5 s default lease" for h, st in stats.items())

    print(f"[fabric] {card}: (a) amg_test {' '.join(FABRIC_ARGS)} -m mc "
          f"--serve 1 --hosts 2 --placement load, phase 11's GBDT + vgg "
          f"registry, as a subprocess: h1 SIGKILLed with one user finished "
          f"and {fab['moved']} in flight ({fab['moved_users']}); every user "
          f"finished once (one finish record each), its queried songs the "
          f"sequential CLI's every epoch (max |F1 diff| "
          f"{fab['f1_a'][0]:.3e}, at (user, epoch) {fab['f1_a'][1]}); "
          f"validate_journal_file clean; {fab['spans']} "
          f"merged spans, 0 orphans; kill to revoke "
          f"{fab['kill_to_revoke_s']:.3f} s, revoke to the moved user's "
          f"re-admission {fab['revoke_to_readmit_s']:.3f} s; the card's "
          f"memory.used peaked "
          + ("not measured" if fab["a_mem"] is None
             else f"{fab['a_mem']} MiB above its level before the run "
                  "(the 2 workers)")
          + "; " + hosts(fab["a_stats"]))
    print(f"[fabric] {card} ({power}): (a) users/s served by 2 hosts "
          f"{FABRIC_USERS / fab['a_wall']:.4f} ({fab['a_wall']:.2f} s, "
          f"the coordinator's and workers' start-up and the failover "
          f"included) vs phase 19 (c)'s single-host --serve 2 "
          f"{serve_cli['users'] / serve_cli['serve_wall_s']:.4f} "
          f"({serve_cli['serve_wall_s']:.2f} s, in-process); the "
          f"sequential CLI {FABRIC_USERS / fab['seq_wall']:.4f}")
    print(f"[fabric] {card}: (b) the same run's coordinator killed at "
          f"fabric.assign hit {FABRIC_USERS + 1} (the failover's) with "
          f"{fab['b_done_before']} finished, restarted: "
          f"{len(fab['b_orphans'])} worker(s) of the killed run alive at "
          f"the restart, none after it; {fab['b_skipped']} finished users "
          f"skipped; every user finished once, on (a)'s queried songs (max "
          f"|F1 diff| {fab['f1_b'][0]:.3e} at {fab['f1_b'][1]}); journal "
          f"clean, 0 orphan spans")
    print(f"[fabric] {card}: (c), run beside (b): {fab['c_users']} users, "
          f"5 GaussianNB + 5 "
          f"SGD, amg_test {' '.join(FABRIC_C_ARGS)} --serve 1 --hosts 1 "
          f"--min-hosts 1 --max-hosts 2 --scale-down-s "
          f"{FABRIC_SCALE_DOWN_S}: one spawn (scale_up), then drain of "
          f"{fab['c_victim']}: fence of {fab['c_fence']['user']} acked at "
          f"generation {fab['c_fence']['gen']}, assign elsewhere, "
          f"drain_done; every user's metrics and state equal its sequential"
          f" run's; journal clean; {fab['c_orphans']} orphan spans (the "
          f"fenced iteration's host steps: its al_iter span is never "
          f"ended); {fab['c_wall']:.1f} s; " + hosts(fab["c_stats"]))
    if fab["launches"]:
        raise AssertionError(f"fabric: {fab['launches']} linear_mc launches")
    print(f"[fabric] {card}: linear_mc launches over phase 20, every "
          f"process counted: {fab['launches']}; phase 20 "
          f"{fab['wall_s']:.1f} s")


# -- slice 12: the operator plane and the generic members -------------------


class StatusPoll:
    """Phase 21 (a): a thread reading a run's status directory every
    STATUS_POLL_S s, as an operator's ``top`` would: per host the distinct
    snapshot times seen and their validation, the frame ``top --once``
    prints at each read (``--stale-s STATUS_STALE_S``), and the wall time
    each host's frame first showed STALE."""

    def __init__(self, users_dir):
        self.dir = os.path.join(users_dir, "status")
        self.times = {}      # host -> distinct snapshot t, in order
        self.invalid = []    # (host, errors)
        self.stale = {}      # host -> [wall times its frame showed STALE]
        self.all_three = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="status-poll", daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self, not_before=None):
        """Stop reading (not before wall time ``not_before``)."""
        if not_before is not None:
            time.sleep(max(0.0, not_before - time.time()))
        self._stop.set()
        self._thread.join()

    def _loop(self):
        while not self._stop.is_set():
            self.poll()
            self._stop.wait(STATUS_POLL_S)

    def poll(self):
        now = time.time()
        snaps = read_status_dir(self.dir)
        for host, snap in snaps.items():
            seen = self.times.setdefault(host, [])
            if not seen or seen[-1] != snap.get("t"):
                seen.append(snap.get("t"))
                errors = validate_status(snap)
                if errors:
                    self.invalid.append((host, errors))
        frame = top_cli.render(snaps, now=now, stale_s=STATUS_STALE_S)
        heads = {}
        for line in frame.splitlines():
            m = re.match(r"(?:\x1b\[2m)?\[([^\]]+)\]", line)
            if m:
                heads[m.group(1)] = line
        if {"coordinator", "h0", "h1"} <= set(heads):
            self.all_three = True
        for host, line in heads.items():
            if "STALE" in line:
                self.stale.setdefault(host, []).append(now)

    def largest_gap(self, host):
        ts = [t for t in self.times.get(host, ()) if t is not None]
        return max((b - a for a, b in zip(ts, ts[1:])), default=None)


def _captured(main, argv):
    """``main(argv)`` of a CLI in this process: (exit code, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def fsck_checks(root, a_users, c_users):
    """Phase 21 (c): fsck over phase 20 (a)'s and (c)'s users directories
    (exit 0), then over a copy of (a)'s with a byte flipped in the
    journal's middle line and in a member ``.npz``: exit 1 naming both;
    ``--repair`` quarantines the line, the member stays reported (exit 1),
    the repaired journal validates."""
    from consensus_entropy_tpu_torch.resilience import io as dio
    from consensus_entropy_tpu_torch.serve import validate_journal_file

    out = {}
    for name, users in (("a", a_users), ("c", c_users)):
        t0 = time.perf_counter()
        rc, text = _captured(fsck_cli.main, [users])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"fsck ({name}): exit {rc}:\n"
                                 f"{text[-3000:]}")
        rep = fsck_cli.scan_users_dir(users)
        out[name] = {"wall_s": wall, "files": {
            "wal": len(rep["wals"]), "ckpt": len(rep["checkpoints"]),
            "npz": len(rep["members"]), "state": len(rep["states"]),
            "tmp": len(rep["stale_tmps"])},
            "wal_lines": sum(w["lines"] for w in rep["wals"])}
    copy_dir = os.path.join(root, "fsck_copy", "users")
    shutil.copytree(a_users, copy_dir)
    jp = os.path.join(copy_dir, "serve_journal.jsonl")
    with open(jp, "rb") as f:
        data = bytearray(f.read())
    starts = [0] + [i + 1 for i, b in enumerate(data) if b == 0x0A]
    mid = (len(starts) - 1) // 2
    data[(starts[mid] + starts[mid + 1]) // 2] ^= 0xFF
    with open(jp, "wb") as f:
        f.write(bytes(data))
    member = next(m["path"] for m in fsck_cli.scan_users_dir(
        copy_dir)["members"] if "classifier_gnb" in m["path"])
    with open(member, "r+b") as f:
        f.seek(os.path.getsize(member) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    rc, text = _captured(fsck_cli.main, [copy_dir])
    if rc != 1 or f"wal  {jp}" not in text or "1 corrupt" not in text \
            or f"npz  {member}: CRC32 mismatch" not in text:
        raise AssertionError(f"fsck (flipped): exit {rc}:\n{text[-3000:]}")
    rc, text = _captured(fsck_cli.main, [copy_dir, "--repair"])
    after = fsck_cli.scan_users_dir(copy_dir)
    if rc != 1 or "quarantined 1 line(s)" not in text \
            or not os.path.exists(dio.quarantine_path(jp)) \
            or [m["path"] for m in after["members"] if m["error"]] \
            != [member] or validate_journal_file(jp):
        raise AssertionError(f"fsck (repair): exit {rc}:\n{text[-3000:]}")
    out["flipped"] = {"journal_line": mid + 1, "member":
                      os.path.relpath(member, copy_dir)}
    return out


def report_check(root, users):
    """Phase 21 (d): ``report --validate --out`` over phase 20 (a)'s users
    directory: exit 0, the merged Chrome trace written."""
    trace_path = os.path.join(root, "report_trace.json")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, text = _captured(report_cli.main,
                             [users, "--validate", "--out", trace_path])
    if rc != 0 or "schema ok" not in err.getvalue():
        raise AssertionError(f"report: exit {rc}: {err.getvalue()[-2000:]}")
    with open(trace_path) as f:
        events = len(json.load(f)["traceEvents"])
    return {"text_lines": len(text.splitlines()), "trace_events": events,
            "validate": err.getvalue().strip().splitlines()[-1]}


def soak_checks(root, trace, run, grade):
    """Phase 21 (d): ``soak gen`` with phase 19 (a)'s trace parameters
    writes a trace whose digest is that of the trace phase 19 drove (and
    ``digest`` says so); ``soak grade`` on phase 19 (a)'s run gives the
    deterministic section ``grade_run`` gave there."""
    path = os.path.join(root, "soak_trace.jsonl")
    argv = ["gen", path, "--seed", str(SERVE_TRACE_SEED), "--users",
            str(SERVE_USERS), "--rate", "4.0", "--class-mix",
            "interactive=0.5,batch=0.5", "--pool-dist", "skew",
            "--pool-sizes", *map(str, SERVE_POOLS), "--horizon-s",
            str(SERVE_TRACE_S)]
    rc, text = _captured(soak_cli.main, argv)
    gen = json.loads(text)
    rc_d, text_d = _captured(soak_cli.main, ["digest", path])
    want = trace_digest(trace)
    if rc or rc_d or gen["trace_sha"] != want \
            or json.loads(text_d)["trace_sha"] != want:
        raise AssertionError(f"soak gen/digest: {gen} {text_d} vs {want}")
    rc, text = _captured(soak_cli.main, [
        "grade", run["users_dir"], "--journal",
        os.path.join(run["users_dir"], "serve_journal.jsonl"), "--trace",
        path, "--slo", "interactive=60,batch=600"])
    graded = json.loads(text)
    if rc != 0 or graded["deterministic"] != grade["deterministic"]:
        raise AssertionError(f"soak grade: exit {rc}: "
                             f"{graded['deterministic']} vs "
                             f"{grade['deterministic']}")
    return {"trace_sha": want, "events": gen["events"],
            "zero_loss": graded["deterministic"]["zero_loss"],
            "lost": graded["deterministic"]["lost_users"]}


def status_check(poll, kill_t, users_dir):
    """Phase 21 (a)'s verdict on ``poll``: live snapshots of the
    coordinator, h0 and h1, every one valid; one frame showing all three;
    h1's frame STALE within STATUS_STALE_S of its SIGKILL at ``kill_t``;
    ``top --once`` on the run's directory renders the fleet."""
    hosts = {h: (len(ts), poll.largest_gap(h))
             for h, ts in sorted(poll.times.items())}
    stale = [t for t in poll.stale.get("h1", ()) if t >= kill_t]
    if poll.invalid or not {"coordinator", "h0", "h1"} <= set(hosts) \
            or not poll.all_three:
        raise AssertionError(f"status: hosts {hosts}, invalid "
                             f"{poll.invalid[:3]}, all three in a frame "
                             f"{poll.all_three}")
    if not stale or stale[0] - kill_t > STATUS_STALE_S:
        raise AssertionError(f"status: h1 STALE at {stale[:3]}, killed at "
                             f"{kill_t}")
    rc, text = _captured(top_cli.main, [users_dir, "--once", "--stale-s",
                                        str(STATUS_STALE_S)])
    if rc != 0 or "[coordinator] fleet" not in text:
        raise AssertionError(f"top --once: exit {rc}:\n{text[-2000:]}")
    snaps = read_status_dir(os.path.join(users_dir, "status"))
    return {"hosts": hosts, "kill_to_stale_s": stale[0] - kill_t,
            "interval_s": snaps["h0"].get("interval_s")}


def phase_operator(card, fab, soak):
    """Phase 21's lines (its runs are made inside phases 11 and 19)."""
    st = fab["status"]
    seen = ", ".join(f"{h}: {n} snapshots, largest gap {g} s"
                     for h, (n, g) in sorted(st["hosts"].items()))
    print(f"[operator] {card}: (a) status snapshots of phase 20 (a)'s run, "
          f"read every {STATUS_POLL_S} s by a thread: {seen}; every one "
          f"clean under validate_status; top --once showed coordinator, h0 "
          f"and h1 in one frame, h1 STALE {st['kill_to_stale_s']:.2f} s "
          f"after its SIGKILL (--stale-s {STATUS_STALE_S}; a snapshot goes "
          f"stale after 3 of its writer's {st['interval_s']} s intervals)")
    print(f"[operator] {card}: (b) phase 20 (c) with --alert-sink "
          f"jsonl:<path> in the coordinator and both workers: "
          f"{fab['alerts']['records']} records, every one parsed "
          f"({fab['alerts']['kinds']}); alert_sink_errors 0 in every "
          f"snapshot ({fab['alerts']['snapshots']})")
    ops = fab["fsck"]
    print(f"[operator] {card}: (c) fsck exit 0 over (a)'s users directory "
          f"({ops['a']['files']} files by class, {ops['a']['wal_lines']} "
          f"WAL lines, {ops['a']['wall_s']:.2f} s) and (c)'s "
          f"({ops['c']['files']}, {ops['c']['wal_lines']} WAL lines, "
          f"{ops['c']['wall_s']:.2f} s); a copy of (a)'s with a byte "
          f"flipped in journal line {ops['flipped']['journal_line']} and "
          f"in {ops['flipped']['member']}: exit 1 naming both; --repair "
          f"quarantined the line, the member still reported (exit 1), the "
          f"repaired journal validates")
    rep = fab["report"]
    print(f"[operator] {card}: (d) report --validate --out over (a)'s "
          f"users directory: {rep['validate']}; {rep['text_lines']} lines "
          f"of text, {rep['trace_events']} trace events; soak gen with "
          f"phase 19 (a)'s parameters: {soak['events']} events, digest "
          f"{soak['trace_sha'][:16]}... equal to the trace phase 19 drove "
          f"(digest too); soak grade on phase 19 (a)'s run: zero loss "
          f"{soak['zero_loss']}, lost {soak['lost']}, its deterministic "
          f"section grade_run's")


def deam_scale_rows():
    """Phase 12's DEAM-scale rows and labels, and their song ids."""
    rng = np.random.default_rng(SEED + 8)
    n = DEAM_SONGS * DEAM_FRAMES
    y = rng.integers(0, C, n)
    centers = rng.normal(0, 0.5, (C, F)).astype(np.float32)
    x = rng.standard_normal((n, F), np.float32) + centers[y]
    return x, y, np.repeat(np.arange(DEAM_SONGS), DEAM_FRAMES), centers


def generic_update_batches(x, y):
    """The boosted slot's two updates after its fit on the first
    GENERIC_CUT_ROWS rows: the next 10 rows, then the first 10 after those
    whose class is not the last (a batch lacking a class, padded by the
    member's remembered row)."""
    first = np.arange(GENERIC_CUT_ROWS, GENERIC_CUT_ROWS + 10)
    rest = np.arange(GENERIC_CUT_ROWS + 10, len(y))
    second = rest[y[rest] != C - 1][:10]
    return [(x[first], y[first]), (x[second], y[second])]


def tree_fingerprint(state, n_class=1):
    """Node count and max depth of every tree of a member's tree arrays,
    and the sum of leaf values of every stage of ``n_class`` trees."""
    offsets = np.asarray(state["offsets"])
    left, right = np.asarray(state["left"]), np.asarray(state["right"])
    inner = np.flatnonzero(left >= 0)
    parent = np.full(len(left), -1)
    parent[left[inner]] = inner
    parent[right[inner]] = inner
    depth = np.zeros(len(left), np.int64)
    up = parent.copy()
    while (up >= 0).any():
        depth += up >= 0
        up = np.where(up >= 0, parent[np.maximum(up, 0)], -1)
    leaf_value = np.where(left < 0, np.asarray(state["value"])[:, 0], 0.0)
    per_tree = np.add.reduceat(leaf_value, offsets[:-1])
    return {"nodes": np.diff(offsets).tolist(),
            "depth": np.maximum.reduceat(depth, offsets[:-1]).tolist(),
            "leaf_sum": per_tree.reshape(-1, n_class).sum(axis=1).tolist(),
            "leaf_abs": float(np.abs(leaf_value).sum())}


def generic_fingerprint(kind, state, sample):
    """What phase 22 holds a fit of ``kind`` to (GENERIC_SIZES): rf's
    trees' node counts and depths, gbc's node counts and per-stage leaf
    sums, svc's support counts, Platt parameters and gamma, gpc's kernel
    parameters; for every kind the column sums of ``predict_proba`` and
    the ``predict`` ids on the ``sample`` rows."""
    from consensus_entropy_tpu_torch.models import generic_members as gm

    fp = {}
    if kind in ("rf", "gbc", "xgb"):
        t = tree_fingerprint(state, 1 if kind == "rf" else C)
        fp["nodes"] = t["nodes"]
        if kind == "rf":
            fp["depth"] = t["depth"]
        else:
            fp["leaf_sum"], fp["leaf_abs"] = t["leaf_sum"], t["leaf_abs"]
    elif kind == "svc":
        fp.update(n_support=[int(v) for v in state["n_support"]],
                  prob_a=[float(v) for v in state["prob_a"]],
                  prob_b=[float(v) for v in state["prob_b"]],
                  gamma=float(state["gamma"]))
    elif kind == "gpc":
        fp.update(constant=[float(v) for v in state["constant"]],
                  length_scale=[float(v) for v in state["length_scale"]])
    pk = "gbc" if kind == "xgb" else kind
    fp["proba_sum"] = gm._PROBA[pk](state, sample).sum(axis=0).tolist()
    fp["predict"] = [int(v) for v in gm._PREDICT[pk](state, sample)]
    return fp


#: each kind's tolerance against GENERIC_SIZES, its CPU tests' (``tests/
#: test_torch_generic_fit.py``): absolute on the listed floats (rf's
#: exact), relative on gpc's kernel parameters; gbc's and the boosted
#: slot's leaf sums within 1e-12 of the leaves' absolute sum
GENERIC_TOL = {"rf": 0.0, "gbc": 1e-12, "xgb": 1e-12, "svc": 1e-6,
               "gpc": 1e-8}


def check_fingerprint(kind, got, want):
    """Raise unless ``got`` is ``want`` within ``kind``'s tolerance: counts
    and ``predict`` ids equal; the probability column sums over
    GENERIC_SAMPLE_ROWS rows within that many times the tolerance."""
    tol = GENERIC_TOL[kind]
    for key, ref in want.items():
        val = got[key]
        if key in ("nodes", "depth", "n_support", "predict"):
            ok = list(val) == list(ref)
        elif key == "leaf_abs":
            continue
        elif key == "leaf_sum":
            ok = np.allclose(val, ref, rtol=0, atol=tol * want["leaf_abs"])
        elif key in ("constant", "length_scale"):
            ok = np.allclose(val, ref, rtol=1e-6, atol=0)
        elif key == "proba_sum":
            ok = np.allclose(val, ref, rtol=0,
                             atol=tol * GENERIC_SAMPLE_ROWS)
        elif key == "gamma":
            ok = np.isclose(val, ref, rtol=1e-12, atol=0)
        else:  # svc's prob_a, prob_b
            ok = np.allclose(val, ref, rtol=0, atol=tol)
        if not ok:
            raise AssertionError(f"generic {kind}: {key} {val} is not "
                                 f"scikit-learn's {ref}")


def generic_fits(x, y):
    """Phase 22's fits without scikit-learn: rf on the first
    GENERIC_RF_ROWS rows, gbc, svc and gpc on the first GENERIC_CUT_ROWS,
    each the JAX registry's estimator with ``random_state=SEED`` (the
    port's ``train.pretrain`` registry); the boosted slot's scikit-learn
    member on the first GENERIC_CUT_ROWS, then its two
    ``generic_update_batches``.  Returns the members, each fit's host-clock
    seconds and the fingerprints (``generic_fingerprint``) on the last
    GENERIC_SAMPLE_ROWS rows."""
    sample = x[-GENERIC_SAMPLE_ROWS:]
    members, secs, fps = {}, {}, {}
    for kind in ("rf", "gbc", "svc", "gpc"):
        rows = GENERIC_RF_ROWS if kind == "rf" else GENERIC_CUT_ROWS
        t0 = time.perf_counter()
        m = pretrain._registry(SEED)[kind]("it_0").fit(x[:rows], y[:rows])
        secs[kind] = time.perf_counter() - t0
        members[kind] = m
        fps[kind] = generic_fingerprint(kind, m.state, sample)
    t0 = time.perf_counter()
    boosted = make_boosted_member("it_0", seed=SEED, impl="sklearn").fit(
        x[:GENERIC_CUT_ROWS], y[:GENERIC_CUT_ROWS])
    secs["xgb"] = time.perf_counter() - t0
    fps["xgb"] = [generic_fingerprint("xgb", boosted.model.state(), sample)]
    for i, (xb, yb) in enumerate(generic_update_batches(x, y)):
        t0 = time.perf_counter()
        boosted.update(xb, yb)
        secs[f"xgb_update_{i}"] = time.perf_counter() - t0
        fps["xgb"].append(generic_fingerprint("xgb", boosted.model.state(),
                                              sample))
    return members, boosted, secs, fps


def check_generic_fits(fps):
    """Every fingerprint against scikit-learn's (GENERIC_SIZES)."""
    for kind in ("rf", "gbc", "svc", "gpc"):
        check_fingerprint(kind, fps[kind], GENERIC_SIZES[kind])
    for got, want in zip(fps["xgb"], GENERIC_SIZES["xgb"], strict=True):
        check_fingerprint("xgb", got, want)


def generic_cli_runs(root, amg_root, host_models):
    """Phase 22, on a copy of phase 11's tree (``beside_main``): the
    registry of phase 11's host members plus one generic member of each
    kind, then ``amg_test`` GENERIC_ARGS on the card and on the CPU."""
    t_all = time.perf_counter()
    x, y, songs, _ = deam_scale_rows()
    reg = {d: os.path.join(root, f"models_generic_{d}")
           for d in ("cuda", "cpu")}
    pre = os.path.join(reg["cuda"], "pretrained")
    shutil.copytree(os.path.join(host_models, "pretrained"), pre)
    # knn: the port's own pre-training, one fold at DEAM scale
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        knn_metrics = pretrain.pretrain_classic("knn", x, y, songs, cv=1,
                                                out_dir=pre, seed=SEED)
    knn_s = time.perf_counter() - t0
    # rf, gbc, svc, gpc and the boosted slot: fitted here, held against
    # scikit-learn's fingerprints of the same rows
    t0 = time.perf_counter()
    fitted, _, fit_s, fps = generic_fits(x, y)
    check_generic_fits(fps)
    fits_s = time.perf_counter() - t0
    for m in fitted.values():
        m.save(os.path.join(pre, Committee.member_file(m)))
    shutil.copytree(pre, os.path.join(reg["cpu"], "pretrained"))
    files = workspace.member_files(pre)
    kinds = {k: files.index(f"classifier_{k}.it_0.npz")
             for k in GENERIC_KINDS}
    registry = {k: GenericMember.load(os.path.join(
        pre, f"classifier_{k}.it_0.npz")) for k in GENERIC_KINDS}
    # every update of a generic member, on either device: its
    # probabilities on GENERIC_SAMPLE_ROWS pool rows before and after
    paths = PathsConfig(models_root=reg["cuda"], amg_root=amg_root)
    real_update = GenericMember.update
    checked = []

    def update(self, X, y_batch):
        sample = sample_rows[0]
        before = self.predict_proba(sample)
        real_update(self, X, y_batch)
        checked.append((self.kind, np.array_equal(
            before, self.predict_proba(sample))))

    sample_rows = []
    runs, walls = {}, {}
    launches = 0
    GenericMember.update = update
    try:
        for d in ("cuda", "cpu"):
            if not sample_rows:
                # the tree's frame pool: the first CLI run caches it
                pool = amg.load_feature_pool(paths.amg_dataset_csv,
                                             paths.amg_features_dir)
                sample_rows.append(pool.X[:GENERIC_SAMPLE_ROWS])
            linear_mc.launches = 0
            t0 = time.perf_counter()
            run_cli(GENERIC_ARGS + ["--models-root", reg[d], "--amg-root",
                                    amg_root, "--device", d])
            walls[d] = time.perf_counter() - t0
            launches += linear_mc.launches
            if linear_mc.launches:
                raise AssertionError(f"generic {d}: linear_mc launched")
            runs[d] = _users_runs(reg[d])
    finally:
        GenericMember.update = real_update
    if len(checked) != 2 * 2 * 2 * len(GENERIC_KINDS) \
            or not all(ok for _, ok in checked):
        raise AssertionError(f"generic: updates {checked}")
    users = sorted(runs["cuda"])
    if len(users) != 2 or sorted(runs["cpu"]) != users:
        raise AssertionError(f"generic: users {users} / "
                             f"{sorted(runs['cpu'])}")
    f1_diff, frozen = 0.0, True
    for u in users:
        m, r = read_metrics(runs["cuda"][u]), read_metrics(runs["cpu"][u])
        if sorted(m) != sorted(r) or len(m) != 3:
            raise AssertionError(f"generic user {u}: epochs {sorted(m)}")
        for e in r:
            if m[e].get("queried") != r[e].get("queried"):
                raise AssertionError(f"generic user {u} epoch {e}: queried "
                                     "songs differ card / CPU")
            f1_diff = max(f1_diff, float(np.max(np.abs(np.subtract(
                m[e]["f1"], r[e]["f1"])))))
            for i in kinds.values():
                frozen &= m[e]["f1"][i] == m[min(m)]["f1"][i]
        for d in ("cuda", "cpu"):
            for k, ref in registry.items():
                got = GenericMember.load(os.path.join(
                    runs[d][u], f"classifier_{k}.it_0.npz"))
                if any(not np.array_equal(got.state[a], v)
                       for a, v in ref.state.items()
                       if not a.startswith("_")):
                    raise AssertionError(f"generic {d} user {u}: the "
                                         f"workspace's {k} is not the "
                                         "registry's")
    if not frozen:
        raise AssertionError("generic: a generic member's F1 moved")
    # each kind's predict_proba and predict at the first user's pool size
    anno = amg.load_annotations(paths.amg_annotations_mat,
                                paths.amg_mapping_mat)
    sub, _ = amg.user_pool(pool, anno, int(users[0]))
    times = {}
    for k, mem in registry.items():
        mem.predict_proba(sub.X[:8])
        t0 = time.perf_counter()
        p = mem.predict_proba(sub.X)
        t1 = time.perf_counter()
        mem.predict(sub.X)
        t2 = time.perf_counter()
        if p.shape != (len(sub.X), C) or not np.isfinite(p).all() \
                or not np.allclose(p.sum(1), 1.0, atol=1e-9):
            raise AssertionError(f"generic {k}: probabilities {p[:2]}")
        times[k] = ((t1 - t0) * 1e3, (t2 - t1) * 1e3)
    sizes = {k: sum(np.asarray(v).nbytes for a, v in registry[k].state.items()
                    if not a.startswith("_")) for k in registry}
    return {"wall_s": time.perf_counter() - t_all, "knn_s": knn_s,
            "knn_f1": knn_metrics, "knn_rows": len(registry["knn"].state[
                "fit_X"]), "fits_s": fits_s, "fit_s": fit_s, "fps": fps,
            "walls": walls,
            "f1_diff": f1_diff, "updates": len(checked), "times": times,
            "pool_rows": len(sub.X), "sizes": sizes, "users": users,
            "order": kinds, "launches": launches}


def phase_generic(card, gen):
    """Phase 22's lines."""
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    fps = gen["fps"]
    print(f"[generic] {card}: registry of {REG_MEMBERS} GaussianNB + "
          f"{REG_MEMBERS} SGD members plus knn (the port's pretrain, one "
          f"fold at DEAM scale: {gen['knn_rows']} stored rows x {F}, "
          f"{gen['knn_s']:.1f} s with its held-out predict, "
          f"{gen['knn_f1']}) and rf, gbc, svc and gpc fitted by the port "
          f"without scikit-learn (rf on {GENERIC_RF_ROWS} rows: "
          f"{len(fps['rf']['nodes'])} trees of {min(fps['rf']['nodes'])}-"
          f"{max(fps['rf']['nodes'])} nodes, depth up to "
          f"{max(fps['rf']['depth'])}; gbc, svc and gpc on "
          f"{GENERIC_CUT_ROWS}: {len(fps['gbc']['nodes'])} gbc trees, svc "
          f"support {fps['svc']['n_support']}, gpc constants "
          f"{fps['gpc']['constant']}), and the boosted slot's scikit-learn "
          f"member ({len(fps['xgb'][0]['nodes'])} trees, then 2 updates of "
          f"10 rows, one lacking class {C - 1}): every fingerprint "
          f"scikit-learn 1.9.0's (GENERIC_SIZES; node counts, depths, "
          f"support counts and predict ids on {GENERIC_SAMPLE_ROWS} rows "
          f"equal, floats within {GENERIC_TOL}); state bytes "
          f"{gen['sizes']}")
    print(f"[generic] {card} ({power}): host-clock fit s: "
          + ", ".join(f"{k} {v:.2f}" for k, v in gen["fit_s"].items())
          + f"; all fits with their checks {gen['fits_s']:.1f} s")
    print(f"[generic] {card}: amg_test {' '.join(GENERIC_ARGS)} on a copy "
          f"of phase 11's tree, card {gen['walls']['cuda']:.1f} s and CPU "
          f"{gen['walls']['cpu']:.1f} s: users {gen['users']}, queried songs "
          f"equal every epoch, max |F1 diff| {gen['f1_diff']:.3e}; "
          f"{gen['updates']} updates of generic members, each leaving its "
          f"probabilities on {GENERIC_SAMPLE_ROWS} pool rows unchanged; "
          f"their F1s constant over the epochs; every workspace's generic "
          f"members the registry's; linear_mc launches 0")
    print(f"[generic] {card} ({power}): host clock ms at the pool's size "
          f"({gen['pool_rows']} frames x {F}), predict_proba / predict: "
          + ", ".join(f"{k} {a:.1f} / {b:.1f}"
                      for k, (a, b) in sorted(gen["times"].items()))
          + f"; phase 22 {gen['wall_s']:.1f} s")


# -- phases 17 and 22 beside phase 11 --------------------------------------


#: how long ``main`` waits for the second process once phase 11 is done
BESIDE_TIMEOUT_S = 600


def exit_with_parent():
    """A daemon thread that kills this process's group once the process
    that started it is gone (the second process runs in a session of its
    own, so a signal to the smoke's group does not reach it)."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os.killpg(0, signal.SIGKILL)

    threading.Thread(target=watch, name="parent-watch", daemon=True).start()


def beside_main(phase, out_json):
    """``chip_smoke.py --beside PHASE OUT``: phase 22 or 17 in a process of
    its own, which ``main`` starts as phase 11 begins and joins after it.
    Neither phase reads phase 11's files: phase 22 writes its own copy of
    phase 11's seeded tree and host registry, phase 17 its own trees.
    Prints the phase's lines; writes its kernel launches and wall time to
    OUT."""
    exit_with_parent()
    card = phase_device(quiet=True)
    t0 = time.perf_counter()
    launches = 0
    if phase == "22":
        with tempfile.TemporaryDirectory() as root:
            amg_root = write_amg_tree(root)
            host_models = os.path.join(root, "models_cuda")
            write_registry(host_models)
            generic = generic_cli_runs(root, amg_root, host_models)
        phase_generic(card, generic)
        launches = generic["launches"]
    else:
        phase_pretrain(card)
    with open(out_json, "w") as f:
        json.dump({"launches": launches,
                   "wall_s": time.perf_counter() - t0}, f)


class Beside:
    """Phase ``phase`` in a second process (``beside_main``), started in a
    session of its own: ``join`` waits for it, prints its lines and fails
    with it; ``stop`` kills its group if it still runs."""

    def __init__(self, root, phase):
        here = os.path.dirname(os.path.abspath(__file__))
        self.phase = phase
        self.out = os.path.join(root, f"beside_{phase}.json")
        self.logs = [os.path.join(root, f"beside_{phase}.{s}")
                     for s in ("out", "err")]
        files = [open(p, "w") for p in self.logs]
        try:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--beside",
                 phase, self.out], cwd=here, stdout=files[0],
                stderr=files[1], start_new_session=True)
        finally:
            for f in files:
                f.close()

    def join(self, timeout):
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            rc = None
        with open(self.logs[0], errors="replace") as f:
            sys.stdout.write(f.read())
        with open(self.logs[1], errors="replace") as f:
            err = f.read()
        if rc != 0:
            raise AssertionError(
                f"beside: phase {self.phase} "
                + ("ran past its wait" if rc is None else f"exited {rc}")
                + f":\n{err[-3000:]}")
        with open(self.out) as f:
            return json.load(f)

    def stop(self):
        if self.proc.poll() is None:
            with contextlib.suppress(OSError):
                os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()


def main():
    t0 = time.perf_counter()
    walls = {}

    def lap(name):
        walls[name] = time.perf_counter() - t0 - sum(walls.values())
        # where a cut run stopped shows at the end of its standard error
        print(f"[progress] {name} done at {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)

    if sys.argv[1:2] == ["--serve-drill"]:
        serve_drill_main(sys.argv[2])
        return
    if sys.argv[1:2] == ["--beside"]:
        beside_main(*sys.argv[2:4])
        return
    card = phase_device()
    if sys.argv[1:] == ["--sgd-fold"]:
        phase_sgd_fold(card)
        return
    phase_build()
    phase_small()
    x, w, b = make_inputs(M, N, K, F, C, SEED)
    mask = np.random.default_rng(SEED + 1).random(N) >= MASKED_SHARE
    xt, w_p, b_p, mt, max_err = phase_full(x, w, b, mask)
    launches, scorer = phase_slice(x, w, b)
    times = phase_times(xt, w_p, b_p, mt, scorer, card)
    del xt, w_p, b_p, mt, scorer
    torch.cuda.empty_cache()
    lap("1-6")
    committee, pool, table, mem = phase_members(x)
    tables, hc = phase_acquire(table)
    phase_acquire_times(committee, pool, tables, hc, mem, card)
    del committee, pool, table   # phase 18 takes the tables again
    torch.cuda.empty_cache()
    lap("7-9")
    phase_al_loop(x, card)
    lap("10")
    # phases 22 and 17 run beside phase 11, each in a process of its own;
    # all three load the one host library
    native.build()
    with tempfile.TemporaryDirectory() as side_root:
        beside = [Beside(side_root, p) for p in ("22", "17")]
        try:
            fleet_cli, mesh_cli, serve_cli, fabric_cli = phase_al_cli(card)
            lap("11")
            side = {proc.phase: proc.join(BESIDE_TIMEOUT_S)
                    for proc in beside}
        finally:
            for proc in beside:
                proc.stop()
    lap("waiting for 17 and 22")
    phase_gbdt(card)
    lap("12")
    phase_cnn(card)
    torch.cuda.empty_cache()
    lap("13")
    user = amg_user_on_card()
    host = phase_al_loop_full(card, user)
    lap("14")
    phase_trunks(card, user, host)
    torch.cuda.empty_cache()
    lap("15")
    phase_fleet(card, user, host, fleet_cli)
    del user, host
    torch.cuda.empty_cache()
    lap("16")
    mesh = phase_mesh(card, x, w, b, mask, tables, hc, mesh_cli)
    del tables, hc
    torch.cuda.empty_cache()
    lap("18")
    serve = phase_serve(card, serve_cli)
    lap("19")
    phase_fabric(card, fabric_cli, serve_cli)
    phase_operator(card, fabric_cli, serve["soak"])
    print("[wall] host clock, s by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items())
        + f" (18 (d) ran inside 11: {mesh_cli['wall_s']:.1f}; 19 (c): "
        f"{serve_cli['wall_s']:.1f}; 20 and 21 (a)-(c): "
        f"{fabric_cli['wall_s']:.1f}; beside 11, each in a process of its "
        f"own: 22 {side['22']['wall_s']:.1f}, 17 {side['17']['wall_s']:.1f})"
        + f"; total {time.perf_counter() - t0:.1f}")
    ops_launches = fabric_cli["ops_launches"] + serve["soak"]["launches"]
    print(json.dumps({"kernels": [{
        "name": "linear_mc", "route": "cuda", "design": "wgmma-3xtf32",
        "source": "consensus_entropy_tpu_torch/csrc/linear_mc.cu",
        "replaces": "consensus_entropy_tpu/experimental/pallas_scoring.py:131",
        "launches": launches + mesh["launches"] + serve["launches"]
        + fabric_cli["launches"] + ops_launches + side["22"]["launches"],
        "launches_by_phase": {"5": launches, "18": mesh["launches"],
                              "19": serve["launches"],
                              "20": fabric_cli["launches"],
                              "21": ops_launches,
                              "22": side["22"]["launches"]},
        "max_abs_err": max(max_err, mesh["max_abs_err"]), **times,
        "sharded_ms": mesh["sharded_ms"],
        "sharded_shards": MESH_B2_SHARDS}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
