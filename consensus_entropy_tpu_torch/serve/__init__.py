"""The serve layer: continuous-batching admission on top of the fleet engine.

Counterpart of ``consensus_entropy_tpu/serve/``:

- :mod:`serve.buckets`: pool-width bucketing at admission (each user pads
  to a bucket edge, not the cohort's largest pool);
- :mod:`serve.server`: the bounded, priority-aware admission queue and
  ``FleetServer``, which keeps ``target_live`` sessions in the engine and
  refills a slot the moment one frees; a drain finishes in-flight users
  and leaves the queue for the rerun;
- :mod:`serve.journal`: the admission WAL (``users/serve_journal.jsonl``,
  CRC-framed, the JAX package's bytes), the poison list and
  ``JsonlTail``, so a server killed and restarted loses no user;
- :mod:`serve.watchdog`: wall-clock deadlines on host steps and device
  dispatches;
- :mod:`serve.breaker`: a per-bucket circuit breaker that degrades a
  failing width to per-user dispatch;
- :mod:`serve.planner`: SLO-aware admission (journaled adaptive bucket
  edges, priority classes, adaptive holds);
- the multi-host fabric: :mod:`serve.fabric` (the coordinator: users
  sharded across worker processes through the journal, lease failover,
  compaction, epoch fencing, the elastic and self-healing planes),
  :mod:`serve.hosts` (the worker: one ``FleetServer`` fed from its
  assignment file, heartbeating through a lease file),
  :mod:`serve.placement`, :mod:`serve.elastic` and :mod:`serve.remedy`
  (the pure decision kernels).

Each user's result under ``--serve`` or ``--hosts`` is its sequential
``ALLoop`` run's, through bucketed padding, the planner's holds, eviction
with resume, degraded dispatch behind an open breaker, restart from the
journal and failover or migration to another host.
"""

from consensus_entropy_tpu_torch.serve.breaker import DispatchBreaker
from consensus_entropy_tpu_torch.serve.buckets import (
    BucketRouter,
    validate_bucket_widths,
)
from consensus_entropy_tpu_torch.serve.elastic import (
    FleetPlanner,
    drain_victim,
    next_host_id,
    scale_down_ok,
    target_hosts,
)
from consensus_entropy_tpu_torch.serve.fabric import (
    FabricConfig,
    FabricCoordinator,
    FabricError,
)
from consensus_entropy_tpu_torch.serve.hosts import HostLease, run_worker
from consensus_entropy_tpu_torch.serve.journal import (
    AdmissionJournal,
    JournalState,
    JsonlTail,
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
from consensus_entropy_tpu_torch.serve.placement import (
    PLACEMENT_POLICIES,
    bucket_for,
    place,
    place_user,
    plan_failover,
    plan_rebalance,
)
from consensus_entropy_tpu_torch.serve.remedy import (
    GRAY_RUNGS,
    cooldown_ok,
    degrade_depth,
    fence_expired,
    gray_rung,
    pick_shed,
    probation_clear,
    remedy_due,
    shed_count,
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
           "FabricConfig", "FabricCoordinator", "FabricError",
           "FleetPlanner", "FleetServer", "GRAY_RUNGS", "HostLease",
           "JournalState", "JsonlTail", "PLACEMENT_POLICIES",
           "PRIORITY_CLASSES", "PoisonList", "QueueClosed", "QueueFull",
           "ServeConfig", "SingleWriterViolation", "Watchdog",
           "WatchdogTimeout", "admission_hold", "bucket_for",
           "cooldown_ok", "degrade_depth", "derive_edges", "dispatch_hold",
           "drain_victim", "fence_expired", "gray_rung", "next_host_id",
           "pick_shed", "place", "place_user", "plan_failover",
           "plan_rebalance", "probation_clear", "remedy_due", "run_worker",
           "scale_down_ok", "shed_count", "target_hosts",
           "validate_bucket_widths", "validate_journal_file"]
