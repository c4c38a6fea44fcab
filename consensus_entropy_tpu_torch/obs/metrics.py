"""Host-clock phase timing, metrics, sketches and the event writer.

Counterpart of ``consensus_entropy_tpu/obs/metrics.py``: ``ema``
(``:42-48``), ``StepTimer`` (``:50-92``; named phase durations accumulate
until ``flush`` writes one record, to ``timings.jsonl`` when a path is
given), ``RollingStat`` (``:95-135``), ``Counter``, ``Gauge``,
``Histogram`` and ``QuantileSketch`` (``:133-344``), ``MetricsRegistry``
and ``EventWriter`` (``:340-417``).

The histogram is log-bucketed (bounded state on an unbounded stream) and
keeps an exact sample reservoir up to ``max_samples``: while it holds,
``percentile`` is numpy's ``linear`` percentile bit for bit; past it, the
upper edge of the log bucket (flagged ``exact: False``).  The sketch adds
``merge`` and a dict round trip, so the admission journal can carry it and
a restarted server re-derives the same bucket edges.  Both give the JAX
package's percentiles and dicts on the same samples.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time

#: the ``fleet_metrics.jsonl`` line-format version (the JAX package's)
SCHEMA_VERSION = 2


def ema(prev: float | None, x: float, alpha: float = 0.3) -> float:
    """One exponential-moving-average step, seeded by the first value:
    the planner's inter-arrival and host-step predictors."""
    return x if prev is None else alpha * x + (1.0 - alpha) * prev


class StepTimer:
    """Usage::

        timer = StepTimer(path)           # or StepTimer(None): in memory
        with timer.phase("score"):
            ...
        timer.flush(epoch=3)              # {"epoch": 3, "score_s": ...}
    """

    def __init__(self, jsonl_path: str | None = None):
        self.jsonl_path = jsonl_path
        self._acc: dict[str, float] = {}
        self.records: list[dict] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] = (self._acc.get(name, 0.0)
                               + time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Accumulate a duration measured elsewhere (a background job's;
        such phases overlap the foreground ones)."""
        self._acc[name] = self._acc.get(name, 0.0) + seconds

    def flush(self, **labels) -> dict:
        """Close the current record: labels + ``{phase}_s`` durations."""
        rec = dict(labels)
        rec.update({f"{k}_s": round(v, 6) for k, v in self._acc.items()})
        self._acc = {}
        self.records.append(rec)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec


class RollingStat:
    """Streaming count / mean / min / max / last of an unbounded stream."""

    __slots__ = ("n", "total", "min", "max", "last")

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.last = None

    def add(self, value: float) -> None:
        v = float(value)
        self.n += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self.last = v

    def snapshot(self, ndigits: int = 4) -> dict | None:
        """``{"n", "mean", "min", "max", "last"}``; ``None`` before the
        first observation."""
        if not self.n:
            return None
        return {"n": self.n, "mean": round(self.total / self.n, ndigits),
                "min": round(self.min, ndigits),
                "max": round(self.max, ndigits),
                "last": round(self.last, ndigits)}


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last observed value (queue depth, live sessions)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v: float) -> None:
        self.value = v

    def snapshot(self):
        return self.value


class Histogram:
    """Log-bucketed histogram with an exact reservoir (module docstring).

    ``growth``: the geometric bucket ratio (``2**0.25``: four buckets a
    doubling).  ``max_samples``: the reservoir's bound; the buckets keep
    counting past it, so the fallback loses resolution, never
    observations."""

    def __init__(self, *, growth: float = 2 ** 0.25,
                 max_samples: int = 4096):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.growth = growth
        self.max_samples = max_samples
        self.n = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._log_g = math.log(growth)
        self._buckets: dict[int, int] = {}
        self._samples: list[float] | None = []

    #: the bucket of values <= 0 (a clock hiccup must not raise here)
    _NONPOS = -(10 ** 9)

    def _index(self, v: float) -> int:
        if v <= 0.0:
            return self._NONPOS
        return math.floor(math.log(v) / self._log_g + 1e-9)

    def add(self, value: float) -> None:
        v = float(value)
        self.n += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        i = self._index(v)
        self._buckets[i] = self._buckets.get(i, 0) + 1
        if self._samples is not None:
            if len(self._samples) < self.max_samples:
                self._samples.append(v)
            else:
                self._samples = None  # reservoir spent: buckets only

    @property
    def exact(self) -> bool:
        """True while every observation is in the reservoir."""
        return self._samples is not None

    @property
    def mean(self) -> float | None:
        return self.total / self.n if self.n else None

    def percentile(self, q: float) -> float | None:
        """The ``q``-th percentile (0..100): numpy's ``linear`` one while
        the reservoir holds (its lerp, the branch at 0.5 included, so the
        value is bit-equal), else the upper edge of the log bucket holding
        the rank, an upper bound of the true quantile."""
        if not self.n:
            return None
        if self._samples is not None:
            s = sorted(self._samples)
            rank = (q / 100.0) * (len(s) - 1)
            lo = math.floor(rank)
            hi = math.ceil(rank)
            frac = rank - lo
            diff = s[hi] - s[lo]
            if frac >= 0.5:
                return s[hi] - diff * (1.0 - frac)
            return s[lo] + diff * frac
        rank = math.ceil((q / 100.0) * self.n)
        cum = 0
        for i in sorted(self._buckets):
            cum += self._buckets[i]
            if cum >= max(rank, 1):
                if i == self._NONPOS:
                    return float(self.min)
                return min(self.growth ** (i + 1), float(self.max))
        return float(self.max)

    def snapshot(self, ndigits: int = 4) -> dict | None:
        """``n``, ``mean``, ``min``, ``max``, ``p50``, ``p95``, ``p99``
        (``None`` before the first observation); ``exact`` appears only
        when False."""
        if not self.n:
            return None
        out = {"n": self.n, "mean": round(self.mean, ndigits),
               "min": round(self.min, ndigits),
               "max": round(self.max, ndigits),
               "p50": round(self.percentile(50), ndigits),
               "p95": round(self.percentile(95), ndigits),
               "p99": round(self.percentile(99), ndigits)}
        if not self.exact:
            out["exact"] = False
        return out


class QuantileSketch(Histogram):
    """A mergeable :class:`Histogram`: the SLO planner's view of the
    enqueue-time pool sizes (``serve.planner``).

    :meth:`merge` is associative: bucket counts add, and the reservoir
    survives when the combined count still fits its bound, a decision
    that depends on the total only.  :meth:`to_dict` / :meth:`from_dict`
    round-trip the whole state for the admission journal."""

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        if (other.growth != self.growth
                or other.max_samples != self.max_samples):
            raise ValueError("cannot merge sketches with different "
                             "growth/max_samples geometry")
        if not other.n:
            return self
        self.n += other.n
        self.total += other.total
        self.min = other.min if self.min is None \
            else min(self.min, other.min)
        self.max = other.max if self.max is None \
            else max(self.max, other.max)
        for i, c in other._buckets.items():
            self._buckets[i] = self._buckets.get(i, 0) + c
        if (self._samples is not None and other._samples is not None
                and self.n <= self.max_samples):
            self._samples = self._samples + other._samples
        else:
            self._samples = None  # the combined stream is past the bound
        return self

    def to_dict(self) -> dict:
        return {"growth": self.growth, "max_samples": self.max_samples,
                "n": self.n, "total": self.total, "min": self.min,
                "max": self.max,
                "buckets": {str(i): c for i, c in self._buckets.items()},
                "samples": (list(self._samples)
                            if self._samples is not None else None)}

    @classmethod
    def merge_all(cls, sketches) -> "QuantileSketch":
        """Fold sketch dicts (the journaled form of the hosts' planner
        records) into one fresh sketch; the fabric's fleet planner feeds
        them sorted by host id (JAX ``obs/metrics.py:317``)."""
        out = None
        for d in sketches:
            sk = cls.from_dict(d)
            out = sk if out is None else out.merge(sk)
        return out if out is not None else cls()

    @classmethod
    def from_dict(cls, d: dict) -> "QuantileSketch":
        sk = cls(growth=float(d.get("growth", 2 ** 0.25)),
                 max_samples=int(d.get("max_samples", 4096)))
        sk.n = int(d.get("n", 0))
        sk.total = float(d.get("total", 0.0))
        sk.min = d.get("min")
        sk.max = d.get("max")
        sk._buckets = {int(i): int(c)
                       for i, c in (d.get("buckets") or {}).items()}
        samples = d.get("samples")
        sk._samples = [float(v) for v in samples] \
            if samples is not None else None
        return sk


class MetricsRegistry:
    """Name-keyed metric instances, get-or-create; asking for an existing
    name as another kind raises."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(**kw)
        elif type(m) is not cls:
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(name, Histogram, **kw)

    def rolling(self, name: str) -> RollingStat:
        return self._get(name, RollingStat)

    def snapshot(self) -> dict:
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}


class EventWriter:
    """The JSONL event writer: thread-safe, each record tagged with
    ``schema``, flushed per record (telemetry, not a log to replay: no
    fsync).  ``path=None`` writes nothing."""

    def __init__(self, path: str | None, schema: int = SCHEMA_VERSION):
        self.path = path
        self.schema = schema
        self._f = None
        self._lock = threading.Lock()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def emit(self, rec: dict) -> dict:
        """Write one record (``schema`` first unless present); returns it
        as written."""
        if "schema" not in rec:
            rec = {"schema": self.schema, **rec}
        if self.path is not None:
            line = (json.dumps(rec) + "\n").encode("utf-8")
            with self._lock:
                if self._f is None:
                    self._f = open(self.path, "ab")
                self._f.write(line)
                self._f.flush()
        return rec

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
