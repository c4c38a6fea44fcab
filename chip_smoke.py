#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

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
    ``device_members``; q=10, 10 iterations, train size 0.85) for mc, hc,
    mix, rand and wmc, each into a fresh workspace: queried songs disjoint,
    the pool shrinking by q, finite F1s, the state at ``next_epoch`` 10,
    iteration 0's selection against the same loop on the CPU (rand ids
    equal; per-slot values within the entropy gate, near-ties counted);
    the median ms of each ``StepTimer`` phase and of the whole iteration,
    and the device busy share over one steady mc iteration;
11. al-cli: ``cli.amg_test.main`` end to end on an AMG1608-shaped tree
    this script writes (1608 songs of 4-8 frames, the 260 feature columns,
    ``.mat`` annotations, a registry of 5 GaussianNB + 5 SGD members from
    the port's ``fit``), on the card and on the CPU: equal ``metrics.jsonl``;
    then a run killed by ``CETPU_FAULTS=state.save:kill@2`` and its rerun
    reach the uninterrupted run's metrics and state.

Every check raises, so any failure exits non-zero and prints no result.
The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits non-zero.
"""

import contextlib
import copy
import csv
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from consensus_entropy_tpu_torch import acquire  # noqa: E402
from consensus_entropy_tpu_torch.al.acquisition import Acquirer  # noqa: E402
from consensus_entropy_tpu_torch.al.linear_pool import LinearPoolScorer  # noqa: E402
from consensus_entropy_tpu_torch.al import state as al_state  # noqa: E402
from consensus_entropy_tpu_torch.al.loop import ALLoop, UserData  # noqa: E402
from consensus_entropy_tpu_torch.cli import amg_test  # noqa: E402
from consensus_entropy_tpu_torch.config import (  # noqa: E402
    FEATURE_SLICE_START,
    FEATURE_SLICE_STOP,
    ALConfig,
)
from consensus_entropy_tpu_torch.convert import (  # noqa: E402
    device_members_from_numpy,
    linear_members_from_jax,
)
from consensus_entropy_tpu_torch.kernels import build, linear_mc  # noqa: E402
from consensus_entropy_tpu_torch.models.committee import (  # noqa: E402
    Committee,
    DeviceMemberCommittee,
    FramePool,
)
from consensus_entropy_tpu_torch.models.members import (  # noqa: E402
    GNBMember,
    SGDMember,
)
from consensus_entropy_tpu_torch.obs.metrics import StepTimer  # noqa: E402
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
# the port's committee of host members runs (qbdc needs a CNN member).
AL_EPOCHS, TRAIN_SIZE, AL_MODES = 10, 0.85, ("mc", "hc", "mix", "rand", "wmc")
# Labelled rows each member is fitted on (its own seeded draw), the class
# centres' spread, and the steady iteration traced for the busy share.
GNB_FIT_ROWS, SGD_FIT_ROWS, CENTER_SD, PROFILED_EPOCH = 4000, 128, 0.1, 5
TIMED_PHASES = ("score", "select", "update_host", "evaluate", "checkpoint",
                "ckpt_join")
# The CLI (phase 11) at AMG1608's shape: songs, frames per song, annotators
# and each one's chance to annotate a song, registry members of each kind.
AMG_SONGS, AMG_FRAMES, AMG_USERS, ANNOTATE_P, REG_MEMBERS = (
    1608, (4, 9), 6, 0.3, 5)
CLI_ARGS = ["-q", "10", "-e", "10", "-m", "mc", "-n", "150", "--max-users",
            "2"]


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


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
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


def _compare_slots(card, host, what):
    """Card and CPU results of one select: same valid slots, values within
    the gate; returns how many slots name another row (near-ties)."""
    v, i = card.values.cpu().numpy(), card.indices.cpu().numpy()
    rv, ri = host.values.numpy(), host.indices.numpy()
    live = rv > -np.inf
    if not np.array_equal(v > -np.inf, live):
        raise AssertionError(f"{what}: valid slots differ")
    np.testing.assert_allclose(v[live], rv[live], rtol=RTOL, atol=ATOL,
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


def busy_share(prof, n_units):
    """The union of a profile's device-side event intervals, as a share of
    the span of all its events and in ms per unit of work; ``None`` when
    the profiler recorded no device time."""
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    return busy / window, busy / 1e3 / n_units


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
    """``StepTimer`` that also records each iteration's wall time (between
    flushes) and traces one iteration (``PROFILED_EPOCH``) with
    ``torch.profiler``."""

    def __init__(self, profile_epoch=None):
        super().__init__(None)
        self.t = time.perf_counter()
        self.profile_epoch = profile_epoch
        self.prof, self.busy = None, None

    def flush(self, **labels):
        epoch = labels.get("epoch")
        if self.prof is not None and epoch == self.profile_epoch:
            torch.cuda.synchronize()
            self.prof.stop()
            self.busy = busy_share(self.prof, 1)
            self.prof = None
        rec = super().flush(**labels)
        now = time.perf_counter()
        rec["iteration_s"], self.t = now - self.t, now
        if self.profile_epoch is not None and epoch == self.profile_epoch - 1:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
        return rec


def run_al_user(mode, members, data, path, device, epochs, profile=False):
    """One user's ``ALLoop.run_user``, recording every scoring result the
    acquirer returns; returns (scoring results, timer, result)."""
    os.makedirs(path)
    committee = Committee(copy.deepcopy(members), device_members=True,
                          device=device)
    timer = IterTimer(PROFILED_EPOCH if profile else None)
    loop = ALLoop(ALConfig(queries=Q, epochs=epochs, mode=mode,
                           train_size=TRAIN_SIZE, seed=SEED), device=device)
    picks, run = [], Acquirer.run_scoring

    def recording(acq, fn_key, inputs):
        res = run(acq, fn_key, inputs)
        picks.append(res)
        return res

    Acquirer.run_scoring = recording
    try:
        return picks, timer, loop.run_user(committee, data, path,
                                           timer=timer)
    finally:
        Acquirer.run_scoring = run


def read_metrics(path):
    """A user's ``metrics.jsonl``, the last record of each epoch."""
    with open(os.path.join(path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["epoch"]: r for r in recs if "event" not in r}


def check_al_run(mode, path, data, n_train):
    """Queried songs disjoint and off the test split, the pool shrinking by
    q, finite F1s, the state committed through the last iteration."""
    recs = read_metrics(path)
    if sorted(recs) != list(range(-1, AL_EPOCHS)):
        raise AssertionError(f"al-loop {mode}: epochs {sorted(recs)}")
    st = al_state.ALState.load(path)
    if st.next_epoch != AL_EPOCHS:
        raise AssertionError(f"al-loop {mode}: next_epoch {st.next_epoch}")
    test = set(st.test_songs)
    seen = set()
    for e in range(AL_EPOCHS):
        q = recs[e]["queried"]
        if len(q) != Q or seen & set(q) or test & set(q):
            raise AssertionError(f"al-loop {mode} iteration {e}: queried "
                                 "songs repeat or leave the train split")
        seen |= set(q)
        if recs[e]["pool_size"] != n_train - Q * (e + 1):
            raise AssertionError(f"al-loop {mode} iteration {e}: pool size "
                                 f"{recs[e]['pool_size']}")
    for e, r in recs.items():
        if len(r["f1"]) != 2 * G_MEMBERS or not np.all(np.isfinite(r["f1"])):
            raise AssertionError(f"al-loop {mode} epoch {e}: F1s {r['f1']}")
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
            picks, timer, res = run_al_user(
                mode, members, data, os.path.join(root, mode, "cuda"),
                "cuda", AL_EPOCHS, profile=mode == "mc")
            launches = linear_mc.launches
            if launches:
                raise AssertionError(f"al-loop {mode}: {launches} linear_mc "
                                     "launches on a path without the kernel")
            recs = check_al_run(mode, os.path.join(root, mode, "cuda"), data,
                                n_train)
            cpu_picks, _, _ = run_al_user(
                mode, members, data, os.path.join(root, mode, "cpu"), "cpu",
                1)
            cpu_recs = read_metrics(os.path.join(root, mode, "cpu"))
            what = f"al-loop {mode} iteration 0, card vs CPU"
            near[mode] = _compare_slots(picks[0], cpu_picks[0], what)
            if mode == "rand" and (recs[0]["queried"]
                                   != cpu_recs[0]["queried"]):
                raise AssertionError(f"{what}: rand ids differ")
            if len(picks) != AL_EPOCHS or not res["trajectory"]:
                raise AssertionError(f"al-loop {mode}: {len(picks)} selects")
            iters = [r for r in timer.records if r["epoch"] >= 0]
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
              f"(StepTimer, host clock, over {AL_EPOCHS}): " + ", ".join(
                  f"{k} {st[k]:.3f}" for k in TIMED_PHASES + ("iteration",))
              + f"; final mean F1 {st['final_f1']:.4f}")
    print(f"[al-loop] {card}: device busy over mc iteration {PROFILED_EPOCH}"
          f" (torch.profiler): " + ("not measured (no device events)"
                                    if busy is None else
                                    f"{busy[0]:.2%}, {busy[1]:.4f} ms"))
    return stats, busy


def write_amg_tree(root, seed=SEED + 6):
    """An AMG1608-shaped tree: per-song openSMILE CSVs with the 260 feature
    columns, ``.mat`` annotations, nothing from pandas."""
    rng = np.random.default_rng(seed)
    middle = [f"feat_{i}" for i in range(F - 2)]
    cols = [FEATURE_SLICE_START] + middle + [FEATURE_SLICE_STOP]
    feats = os.path.join(root, "amg1608", "feats")
    anno = os.path.join(root, "amg1608", "anno")
    os.makedirs(feats)
    os.makedirs(anno)
    centers = rng.normal(0, 2.0, (C, F)) + rng.uniform(-5, 5, F)
    song_ids = np.arange(1, AMG_SONGS + 1)
    song_class = rng.integers(0, C, AMG_SONGS)
    for sid, c in zip(song_ids, song_class):
        k = int(rng.integers(*AMG_FRAMES))
        rows = centers[c] + rng.standard_normal((k, F)) * 3.0
        with open(os.path.join(feats, f"{sid}.csv"), "w", newline="") as f:
            w = csv.writer(f, delimiter=";", lineterminator="\n")
            w.writerow(["frameTime"] + cols)
            for t, row in enumerate(rows.astype(np.float32)):
                w.writerow([f"{t * 0.5:.1f}"] + [repr(float(v)) for v in row])
    lab = np.full((AMG_SONGS, AMG_USERS, 2), np.nan)
    for i, c in enumerate(song_class):
        a_sign = 1.0 if c in (0, 1) else -1.0
        v_sign = 1.0 if c in (0, 3) else -1.0
        for u in range(AMG_USERS):
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
            for u in sorted(os.listdir(users))}


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
        walls = {}
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            run_cli(CLI_ARGS + ["--models-root", roots[d], "--amg-root",
                                amg_root, "--device", d])
            walls[d] = time.perf_counter() - t0
        got, ref = users_metrics(roots["cuda"]), users_metrics(roots["cpu"])
        if sorted(got) != sorted(ref) or len(got) != 2:
            raise AssertionError(f"al-cli: users {sorted(got)} vs "
                                 f"{sorted(ref)}")
        for u in got:
            (m, st), (rm, rst) = got[u], ref[u]
            for e in range(-1, AL_EPOCHS):
                # host members score and evaluate alike on both devices; the
                # selection's consensus entropy is the card's or the CPU's
                if (m[e].get("queried") != rm[e].get("queried")
                        or m[e]["f1"] != rm[e]["f1"]):
                    raise AssertionError(f"al-cli user {u} epoch {e}: card "
                                         "and CPU runs differ")
            if st.next_epoch != AL_EPOCHS:
                raise AssertionError(f"al-cli user {u}: {st.next_epoch}")
        base = CLI_ARGS + ["--models-root", roots["killed"], "--amg-root",
                           amg_root, "--device", "cuda"]
        cmd = [sys.executable, "-m", "consensus_entropy_tpu_torch.cli.amg_test"]
        env = dict(os.environ, PYTHONPATH=here,
                   CETPU_FAULTS="state.save:kill@2")
        killed = subprocess.run(cmd + base, cwd=here, env=env, timeout=600,
                                capture_output=True, text=True)
        if killed.returncode == 0 or "injected kill" not in killed.stderr:
            raise AssertionError(f"al-cli: the kill drill did not kill "
                                 f"(exit {killed.returncode}):\n"
                                 f"{killed.stderr[-2000:]}")
        env.pop("CETPU_FAULTS")
        rerun = subprocess.run(cmd + base, cwd=here, env=env, timeout=600,
                               capture_output=True, text=True)
        if rerun.returncode != 0:
            raise AssertionError(f"al-cli: the rerun exited "
                                 f"{rerun.returncode}:\n{rerun.stderr[-2000:]}")
        resumed = users_metrics(roots["killed"])
        for u in got:
            (m, st), (rm, rst) = got[u], resumed[u]
            if m != rm or st != rst:
                raise AssertionError(f"al-cli user {u}: the resumed run's "
                                     "metrics or state differ")
    print(f"[al-cli] {card}: amg_test {' '.join(CLI_ARGS)} on an "
          f"AMG1608-shaped tree ({AMG_SONGS} songs, {F} feature columns, "
          f"written in {tree_s:.1f} s), {REG_MEMBERS} GaussianNB + "
          f"{REG_MEMBERS} SGD members: card and CPU metrics.jsonl equal "
          f"(queried songs and F1s, every epoch) in {walls['cuda']:.1f} s / "
          f"{walls['cpu']:.1f} s; killed at state.save hit 2, the rerun "
          f"resumed to the uninterrupted run's metrics and state")


def main():
    card = phase_device()
    phase_build()
    phase_small()
    x, w, b = make_inputs(M, N, K, F, C, SEED)
    mask = np.random.default_rng(SEED + 1).random(N) >= MASKED_SHARE
    xt, w_p, b_p, mt, max_err = phase_full(x, w, b, mask)
    launches, scorer = phase_slice(x, w, b)
    times = phase_times(xt, w_p, b_p, mt, scorer, card)
    del xt, w_p, b_p, mt, scorer
    torch.cuda.empty_cache()
    committee, pool, table, mem = phase_members(x)
    tables, hc = phase_acquire(table)
    phase_acquire_times(committee, pool, tables, hc, mem, card)
    del committee, pool, table, tables
    torch.cuda.empty_cache()
    phase_al_loop(x, card)
    phase_al_cli(card)
    print(json.dumps({"kernels": [{
        "name": "linear_mc", "route": "cuda", "design": "wgmma-3xtf32",
        "source": "consensus_entropy_tpu_torch/csrc/linear_mc.cu",
        "replaces": "consensus_entropy_tpu/experimental/pallas_scoring.py:131",
        "launches": launches, "max_abs_err": max_err, **times}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
