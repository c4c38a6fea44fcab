"""The traced run's device trace, reduced in memory.

``torch.profiler`` with CUDA activity alone (the kernels, copies and
sets, and the runtime calls that launched them) runs from the window's
opening until the iterations running at its close have ended; recording
every CPU op as well slows the host-bound retrain two to four times.  No
Chrome trace is written.  Its raw events (unix-epoch ns, the clock of the
scheduler's host steps and spans) are reduced to what the per-layer
metrics read: the device's busy intervals (not the ranges
``record_function`` marks on the device's timeline, such as
``Optimizer.step``), each kernel's name and time, and the host time at
which each kernel was launched (its runtime call, matched by correlation
id).  A kernel is a convolution's when cuDNN's naming says so
(:data:`CONV_KERNELS`).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

#: parts of the names of the kernels cuDNN runs a convolution with, on
#: this card: implicit-GEMM forward and data and filter gradients
#: (``xmma_fprop``/``dgrad``/``wgrad``, ``implicit_gemm``, ``convolve``),
#: Winograd, and the FFT algorithms (``DSE::`` transforms, the complex
#: pointwise products and the complex GEMMs ``cf32``, which nothing else
#: in the program runs)
CONV_KERNELS = ("fprop", "dgrad", "wgrad", "implicit_gemm", "convolve",
                "winograd", "DSE::", "fft", "_complex", "cf32",
                "region_transform", "cudnn")
#: a kernel's name in the breakdown is cut to this many characters
NAME_CHARS = 160


@dataclasses.dataclass
class Kernel:
    name: str
    t0: float  # s, unix epoch
    t1: float
    launch: float | None  # host time of its launch, s
    conv: bool


@dataclasses.dataclass
class TraceData:
    t0: float
    t1: float
    kernels: list

    @property
    def spans(self) -> list:
        return [(k.t0, k.t1) for k in self.kernels]


def _launches(events) -> dict:
    """``{correlation: host s}`` of the runtime calls that launch."""
    out = {}
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CPU:
            continue
        name = e.name()
        if name.startswith("cu") and ("Launch" in name or "Memcpy" in name
                                      or "Memset" in name):
            out[e.correlation_id()] = e.start_ns() / 1e9
    return out


def is_conv(name: str) -> bool:
    return any(p in name for p in CONV_KERNELS)


class DeviceTrace:
    """Start at the window's opening, :meth:`stop` once its running
    iterations have ended, then :meth:`reduce`."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        # the CPU's activity only where there is no card: the traced
        # rehearsal of a cell on the CPU (benchmark/tests)
        self._prof = profile(activities=[
            ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU])
        self.t0 = self.t1 = None

    def start(self) -> None:
        self._prof.start()
        self.t0 = time.time()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.t1 = time.time()

    def reduce(self, t1: float) -> TraceData:
        events = self._prof.profiler.kineto_results.events()
        launch = _launches(events)
        kernels = []
        for e in events:
            # a record_function range on the device's timeline is no work
            if e.device_type() != torch.autograd.DeviceType.CUDA \
                    or e.is_user_annotation():
                continue
            name = e.name()
            kernels.append(Kernel(name, e.start_ns() / 1e9,
                                  e.end_ns() / 1e9,
                                  launch.get(e.correlation_id()),
                                  is_conv(name)))
        self._prof = None
        return TraceData(self.t0, t1, kernels)


def breakdown(trace: TraceData, spans: list, host_steps: list,
              t0: float, t1: float, n: int = 10) -> dict:
    """The device operations that took most time in ``[t0, t1]``, and the
    longest idle gaps of the device, each named by the host work that
    overlapped it most: a dispatch span (``dispatch <fn>``), a pooled
    host step (``host <label>``), or else ``scheduler``."""
    from benchmark import stats

    by_name = collections.Counter()
    for k in trace.kernels:
        lo, hi = max(k.t0, t0), min(k.t1, t1)
        if hi > lo:
            by_name[k.name[:NAME_CHARS]] += hi - lo
    host = [(f"dispatch {s.get('fn')}", s["t0"], s["t0"] + s["dur_s"])
            for s in spans if s.get("name") in ("retrain", "score_dispatch")]
    host += [(f"host {label}", a / 1e9, b / 1e9) for label, a, b in host_steps]
    out = []
    for lo, hi in sorted(stats.gaps(trace.spans, t0, t1),
                         key=lambda g: g[0] - g[1])[:n]:
        cover = collections.Counter()
        for label, a, b in host:
            if b > lo and a < hi:
                cover[label] += min(b, hi) - max(a, lo)
        out.append([cover.most_common(1)[0][0] if cover else "scheduler",
                    hi - lo])
    return {"device_ops": [[k, v] for k, v in by_name.most_common(n)],
            "idle_gaps": out}
