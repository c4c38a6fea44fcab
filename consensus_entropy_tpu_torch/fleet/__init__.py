"""The fleet engine: a cohort of per-user AL sessions on one device.

- :mod:`fleet.session`: the per-user AL loop as a steppable generator,
  driven inline by ``ALLoop.run_user`` and interleaved by the scheduler;
- :mod:`fleet.scheduler`: N sessions at once, their scoring and CNN device
  calls stacked across users, their host work on a bounded worker pool;
- :mod:`fleet.report`: users/s, device-batch occupancy, phase times.
"""

from consensus_entropy_tpu_torch.fleet.report import FleetReport
from consensus_entropy_tpu_torch.fleet.scheduler import (
    FleetScheduler,
    FleetUser,
)
from consensus_entropy_tpu_torch.fleet.session import (
    HostStep,
    ScoreStep,
    UserSession,
    drive_inline,
)

__all__ = ["FleetReport", "FleetScheduler", "FleetUser", "HostStep",
           "ScoreStep", "UserSession", "drive_inline"]
