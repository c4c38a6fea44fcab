"""Host-clock phase timing for the AL loop.

Counterpart of ``consensus_entropy_tpu/obs/metrics.py::StepTimer``
(``:50-92``): named phase durations accumulate until ``flush`` writes one
record, to ``timings.jsonl`` when a path is given.  The span tracer waits
for the serving layer (ROADMAP A10).
"""

from __future__ import annotations

import contextlib
import json
import time


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
