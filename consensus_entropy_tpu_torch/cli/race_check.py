"""``race_check``: the port's host core under ThreadSanitizer and under
oversubscribed OpenMP.

Counterpart of ``scripts/race_check.sh`` for the port's own core
(``native/ce_host.cpp``, ``ce_gbdt.cpp``, ``ce_sgd.cpp``, ``ce_tree.cpp``,
``ce_svm.cpp``, the sources ``native.py`` builds), driven by
``native/ce_stress.cpp``, which calls every exported function of the core
on shared inputs:

1. **tsan**: built with ``g++ -O1 -g -fsanitize=thread -fopenmp``; four
   pthreads call every function concurrently, each with an OpenMP team of
   one (GCC's libgomp is not instrumented, so in-region parallelism would
   be noise): TSAN reports hidden shared mutable state across calls, the
   reentrancy the fleet's concurrent host workers rely on; the callers'
   outputs must be bytewise equal.
2. **determinism**: built with ``g++ -O2 -fopenmp``; at 2, ``nproc``,
   2x and 4x ``nproc`` OpenMP threads, REPS processes each, every function
   runs twice per process with bytewise-equal outputs, and every output's
   digest must be the same at every team size (``native.py``: the team
   size changes no result).  The oversubscribed runs wait passively
   (``OMP_WAIT_POLICY=passive``: spinning threads on a busy core slow the
   run and change no result).

Both builds go to a temporary directory under ``_build/`` (removed at the
end) and use the core's ``-ffp-contract=off``.  A failed compile, a
missing compiler or ThreadSanitizer, or a failed pass raises: the command
exits 1 and never prints ``race check passed``.

The command runs both passes at its sizes; :func:`run` also takes the
passes, the TSAN pass's own sizes and the processes a team size, as
``chip_smoke.py`` phase 23 (b) uses it at DEAM's sizes.

    python -m consensus_entropy_tpu_torch.cli.race_check
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

from consensus_entropy_tpu_torch import native

STRESS_SOURCE = os.path.join(os.path.dirname(native.SOURCE), "ce_stress.cpp")
COMMON_FLAGS = ("-fopenmp", "-ffp-contract=off", "-std=c++17")
TSAN_FLAGS = ("-O1", "-g", "-fsanitize=thread", *COMMON_FLAGS)
DET_FLAGS = ("-O2", *COMMON_FLAGS)
PASSES = ("tsan", "determinism")
#: rows, features, tree rows, svc rows: small enough for tier-1 (~25 s)
DEFAULT_SIZES = (2048, 32, 1024, 200)
#: seconds a compile or one stress run may take before the check fails
STEP_TIMEOUT_S = 900


def tsan_links(build_dir: str) -> bool:
    """Whether ``g++ -fsanitize=thread -fopenmp`` links a program here
    (the probe of ``tests/test_native.py``)."""
    probe = subprocess.run(
        ["g++", "-fsanitize=thread", "-fopenmp", "-x", "c++", "-", "-o",
         os.path.join(build_dir, "probe")],
        input="int main(){return 0;}", text=True, capture_output=True,
        timeout=STEP_TIMEOUT_S)
    return probe.returncode == 0


def thread_counts(cores: int) -> list[int]:
    """2, ``cores``, 2x and 4x ``cores``: each once, none below 2."""
    out = []
    for t in (2, cores, 2 * cores, 4 * cores):
        if t >= 2 and t not in out:
            out.append(t)
    return out


def _compile(flags, out) -> subprocess.Popen:
    if shutil.which("g++") is None:
        raise RuntimeError("race check: no g++ on PATH")
    cmd = ["g++", *flags, *native._sources(), STRESS_SOURCE, "-o", out]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, what: str) -> None:
    try:
        _, err = proc.communicate(timeout=STEP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"race check: the {what} build ran past "
                           f"{STEP_TIMEOUT_S} s") from None
    if proc.returncode != 0:
        raise RuntimeError(f"race check: the {what} build failed "
                           f"({' '.join(proc.args)}), exit "
                           f"{proc.returncode}:\n{err}")


def _run(binary, mode, sizes, env, what) -> str:
    proc = subprocess.run([binary, mode, *map(str, sizes)],
                          capture_output=True, text=True,
                          env={**os.environ, **env},
                          timeout=STEP_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"race check: {what} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr[-6000:]}")
    return proc.stdout


def _digests(stdout: str) -> tuple[dict[str, str], dict[str, float]]:
    """Each output's ``digest/bytes`` and each call group's wall seconds
    (of the first of the run's two passes)."""
    out, walls = {}, {}
    for line in stdout.splitlines():
        if line.startswith("digest "):
            _, name, digest, size = line.split()
            out[name] = f"{digest}/{size}"
        elif line.startswith("wall "):
            _, group, secs = line.split()
            walls[group] = float(secs)
    if not out or "determinism ok" not in stdout:
        raise RuntimeError(f"race check: no digests in\n{stdout}")
    return out, walls


def run(*, passes=PASSES, sizes=DEFAULT_SIZES, tsan_sizes=None,
        threads=None, reps=3, log=print) -> dict:
    """The passes in ``passes`` at ``sizes`` (``rows, features, tree_rows,
    svc_rows``; the TSAN pass at ``tsan_sizes`` when given: it runs about
    ten times slower); ``threads`` defaults to :func:`thread_counts` of
    this process's cores.  Returns each step's wall seconds and the
    outputs checked; raises ``RuntimeError`` on any failure."""
    unknown = set(passes) - set(PASSES)
    if unknown or not passes:
        raise ValueError(f"passes must be among {PASSES}, got {passes}")
    cores = len(os.sched_getaffinity(0))
    threads = list(threads or thread_counts(cores))
    if any(t < 1 for t in threads) or reps < 1:
        raise ValueError(f"threads and reps must be >= 1 ({threads}, "
                         f"{reps})")
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    walls = {}
    build = tempfile.mkdtemp(prefix="race-", dir=native.BUILD_DIR)
    try:
        if "tsan" in passes and not tsan_links(build):
            raise RuntimeError("race check: g++ -fsanitize=thread "
                               "-fopenmp does not link here (no libtsan)")
        t0 = time.perf_counter()
        binaries = {p: os.path.join(build, f"ce_stress_{p}") for p in passes}
        procs = {p: _compile(TSAN_FLAGS if p == "tsan" else DET_FLAGS,
                             binaries[p]) for p in passes}
        for p, proc in procs.items():
            _finish(proc, p)
        walls["build"] = time.perf_counter() - t0
        log(f"race check: built {', '.join(passes)} from "
            f"{len(native._sources()) + 1} sources in "
            f"{walls['build']:.1f} s (rows, features, tree rows, svc rows "
            f"= {', '.join(map(str, sizes))}"
            + (f"; tsan {', '.join(map(str, tsan_sizes))}"
               if tsan_sizes and "tsan" in passes else "")
            + f"; {cores} cores)")
        outputs = 0
        if "tsan" in passes:
            t0 = time.perf_counter()
            out = _run(binaries["tsan"], "tsan", tsan_sizes or sizes,
                       {"OMP_NUM_THREADS": "1",
                        "TSAN_OPTIONS": "halt_on_error=1 "
                        + os.environ.get("TSAN_OPTIONS", "")},
                       "the TSAN pass")
            walls["tsan"] = time.perf_counter() - t0
            log(f"== TSAN reentrancy (4 concurrent callers, OpenMP team "
                f"of 1): {out.strip()} ({walls['tsan']:.1f} s)")
        if "determinism" in passes:
            t0 = time.perf_counter()
            first = None
            by_team = {}
            for t in threads:
                t1 = time.perf_counter()
                for rep in range(reps):
                    got, groups = _digests(_run(
                        binaries["determinism"], "determinism", sizes,
                        {"OMP_NUM_THREADS": str(t),
                         "OMP_WAIT_POLICY": "passive"},
                        f"determinism at {t} threads, run {rep + 1}"))
                    if first is None:
                        first = (t, got)
                    elif got != first[1]:
                        bad = sorted(k for k in got
                                     if got[k] != first[1].get(k))
                        raise RuntimeError(
                            f"race check: outputs {bad} at {t} threads "
                            f"(run {rep + 1}) differ from {first[0]} "
                            "threads'")
                by_team[t] = time.perf_counter() - t1
                log(f"== determinism, OMP_NUM_THREADS={t} (x{reps}): "
                    f"{len(got)} outputs bytewise equal ({by_team[t]:.1f} "
                    "s; a pass's s by call group: " + ", ".join(
                        f"{g} {w:.3f}" for g, w in groups.items()) + ")")
            walls["determinism"] = time.perf_counter() - t0
            walls["by_team"] = by_team
            outputs = len(first[1])
    finally:
        shutil.rmtree(build, ignore_errors=True)
    return {"walls": walls, "threads": threads, "reps": reps,
            "outputs": outputs, "cores": cores}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="race and determinism check of the port's host core")
    rows, features, tree_rows, svc_rows = DEFAULT_SIZES
    p.add_argument("--rows", type=int, default=rows,
                   help="rows of the host-member, GBDT, SGD and gradient calls")
    p.add_argument("--features", type=int, default=features)
    p.add_argument("--tree-rows", type=int, default=tree_rows,
                   help="rows of the two CART builds (at most --rows)")
    p.add_argument("--svc-rows", type=int, default=svc_rows,
                   help="rows of the C-SVC (at most --rows)")
    p.add_argument("--threads", default=None, metavar="T1,T2,...",
                   help="OpenMP team sizes of the determinism pass "
                        "(default: 2, nproc, 2x and 4x nproc)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    threads = [int(t) for t in args.threads.split(",")] \
        if args.threads else None
    t0 = time.perf_counter()
    try:
        run(sizes=(args.rows, args.features, args.tree_rows,
                   args.svc_rows), threads=threads)
    except (RuntimeError, ValueError, subprocess.TimeoutExpired) as e:
        print(f"race check FAILED: {e}", file=sys.stderr)
        return 1
    print(f"race check passed ({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
