"""The serve layer: continuous-batching admission on top of the fleet engine.

Counterpart of ``consensus_entropy_tpu/serve/``, single-host:

- :mod:`serve.buckets`: pool-width bucketing at admission (each user pads
  to a bucket edge, not the cohort's largest pool);
- :mod:`serve.server`: the bounded, priority-aware admission queue and
  ``FleetServer``, which keeps ``target_live`` sessions in the engine and
  refills a slot the moment one frees; a drain finishes in-flight users
  and leaves the queue for the rerun;
- :mod:`serve.journal`: the admission WAL (``users/serve_journal.jsonl``,
  CRC-framed, the JAX package's bytes) and the poison list, so a server
  killed and restarted loses no user;
- :mod:`serve.watchdog`: wall-clock deadlines on host steps and device
  dispatches;
- :mod:`serve.breaker`: a per-bucket circuit breaker that degrades a
  failing width to per-user dispatch;
- :mod:`serve.planner`: SLO-aware admission (journaled adaptive bucket
  edges, priority classes, adaptive holds).

Each user's result under ``--serve`` is its sequential ``ALLoop`` run's,
through bucketed padding, the planner's holds, eviction with resume,
degraded dispatch behind an open breaker and restart from the journal.
The multi-host fabric (placement, hosts, fabric, elastic, remedy) is not
ported yet.
"""

from consensus_entropy_tpu_torch.serve.breaker import DispatchBreaker
from consensus_entropy_tpu_torch.serve.buckets import (
    BucketRouter,
    validate_bucket_widths,
)
from consensus_entropy_tpu_torch.serve.journal import (
    AdmissionJournal,
    JournalState,
    PoisonList,
    SingleWriterViolation,
    validate_journal_file,
)
from consensus_entropy_tpu_torch.serve.planner import (
    DEFAULT_CLASS,
    PRIORITY_CLASSES,
    AdmissionPlanner,
    admission_hold,
    derive_edges,
    dispatch_hold,
)
from consensus_entropy_tpu_torch.serve.server import (
    AdmissionQueue,
    FleetServer,
    QueueClosed,
    QueueFull,
    ServeConfig,
)
from consensus_entropy_tpu_torch.serve.watchdog import (
    Watchdog,
    WatchdogTimeout,
)

__all__ = ["AdmissionJournal", "AdmissionPlanner", "AdmissionQueue",
           "BucketRouter", "DEFAULT_CLASS", "DispatchBreaker",
           "FleetServer", "JournalState", "PRIORITY_CLASSES", "PoisonList",
           "QueueClosed", "QueueFull", "ServeConfig",
           "SingleWriterViolation", "Watchdog", "WatchdogTimeout",
           "admission_hold", "derive_edges", "dispatch_hold",
           "validate_bucket_widths", "validate_journal_file"]
