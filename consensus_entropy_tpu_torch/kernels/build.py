"""Build the port's CUDA kernels from ``csrc/*.cu`` at first use.

Each source compiles with ``nvcc`` into a C-ABI shared library under
``consensus_entropy_tpu_torch/_build/``, named after a hash of every file
under ``csrc/`` (``*.cu``, ``*.cuh``, ``*.h``) and the flags, so an edited
source or header is rebuilt and an unchanged tree is reused.  There is no prebuilt binary: without ``nvcc`` the build raises.

    python -m consensus_entropy_tpu_torch.kernels.build   # build them all
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME and "
                       "/usr/local/cuda); the CUDA kernels cannot be built")


def sources() -> list[str]:
    """Kernel names: the stems of ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(SRC_DIR) if f.endswith(".cu"))


def library_path(name: str) -> str:
    """Where the library for the current sources of ``name`` lives: the
    hash covers ``name``, every source and header under ``csrc/`` (a header
    may be included by any kernel) and the flags."""
    digest = hashlib.sha256(" ".join((name, *NVCC_FLAGS)).encode())
    for fname in sorted(os.listdir(SRC_DIR)):
        if fname.endswith((".cu", ".cuh", ".h")):
            with open(os.path.join(SRC_DIR, fname), "rb") as f:
                digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names=None) -> dict[str, str]:
    """Compile every kernel that is not built yet, one ``nvcc`` per source,
    all started together.  Returns name -> compiler log (ptxas register and
    shared-memory report; empty for a library that was already built).
    Raises with the compiler's output when a build fails."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    logs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            logs[name] = ""
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(SRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            if os.path.exists(tmp):
                os.remove(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library of kernel ``name``, built first if needed."""
    build_all([name])
    return ctypes.CDLL(library_path(name))


if __name__ == "__main__":
    t0 = time.perf_counter()
    for kernel, text in build_all().items():
        print(f"{kernel}: built\n{text}".rstrip())
    print(f"build wall {time.perf_counter() - t0:.3f} s")
