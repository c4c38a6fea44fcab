"""The registry of acquisition modes (counterpart of
``consensus_entropy_tpu.acquire``).

:func:`get`, :func:`register` and :func:`available_modes` are the registry;
``al.acquisition.Acquirer`` resolves its mode here.  Built in: the paper's
``mc`` / ``hc`` / ``mix`` / ``rand``, then ``qbdc`` (query by dropout
committee) and ``wmc`` (weighted machine consensus).
"""

from consensus_entropy_tpu_torch.acquire.base import (
    AcquisitionStrategy,
    available_modes,
    get,
    register,
)
from consensus_entropy_tpu_torch.acquire.builtin import (
    HumanConsensus,
    MachineConsensus,
    MixedConsensus,
    RandomBaseline,
)
from consensus_entropy_tpu_torch.acquire.qbdc import DropoutCommittee
from consensus_entropy_tpu_torch.acquire.wmc import WeightedMachineConsensus

# registration order is the listing order: the paper's four, then the rest
register(MachineConsensus())
register(HumanConsensus())
register(MixedConsensus())
register(RandomBaseline())
register(DropoutCommittee())
register(WeightedMachineConsensus())

__all__ = [
    "AcquisitionStrategy",
    "available_modes",
    "get",
    "register",
    "DropoutCommittee",
    "HumanConsensus",
    "MachineConsensus",
    "MixedConsensus",
    "RandomBaseline",
    "WeightedMachineConsensus",
]
