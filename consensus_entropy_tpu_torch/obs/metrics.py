"""Host-clock phase timing, the metrics registry and the event writer.

Counterpart of ``consensus_entropy_tpu/obs/metrics.py``: ``StepTimer``
(``:50-92``; named phase durations accumulate until ``flush`` writes one
record, to ``timings.jsonl`` when a path is given), ``RollingStat``
(``:95-135``), ``MetricsRegistry`` (``:340-376``) and ``EventWriter``
(``:379-417``), as far as the fleet report uses them.  The histograms and sketches of the serving layer wait
for it (ROADMAP A10).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

#: the ``fleet_metrics.jsonl`` line-format version (the JAX package's)
SCHEMA_VERSION = 2


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


class MetricsRegistry:
    """Name-keyed metric instances, get-or-create; asking for an existing
    name as another kind raises."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif type(m) is not cls:
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

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
