"""Trace-driven load generation and run grading.

``trace`` decides the load shape (pure, seeded, serializable; the same
bytes as the JAX package's for the same spec); ``driver`` plays a trace
against a ``FleetServer`` through its enqueue and backpressure surface;
``grade`` turns the run's durable artifacts into a summary.
"""

from consensus_entropy_tpu_torch.workload.driver import (  # noqa: F401
    DriverStats, ServerTarget, TraceDriver)
from consensus_entropy_tpu_torch.workload.grade import (  # noqa: F401
    deterministic_equal, grade_run, percentile)
from consensus_entropy_tpu_torch.workload.trace import (  # noqa: F401
    Trace, TraceSpec, generate, load, save, spec_from_meta,
    trace_digest, validate_records)
