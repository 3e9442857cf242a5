# The paper's primary contribution: PPAT (privacy-preserving adversarial
# translation), PATE differential privacy, the moments accountant, CSLS and
# the KGEmb update; Alg. 1's federation scheduler with its fault layer; plus
# the serving tier's device and fault helpers.
from repro_torch.core.distributed import committed_device, replica_devices  # noqa: F401
from repro_torch.core.faults import (  # noqa: F401
    Fault,
    FaultError,
    FaultInjector,
    FaultPlan,
    ServeFault,
    ServeFaultError,
    ServeFaultPlan,
)
from repro_torch.core.pate import pate_vote, teacher_votes  # noqa: F401
from repro_torch.core.privacy import MomentsAccountant  # noqa: F401
from repro_torch.core.ppat import PPATConfig, PPATHost, PPATClient, train_ppat  # noqa: F401
from repro_torch.core.alignment import csls, AlignmentRegistry  # noqa: F401
from repro_torch.core.aggregation import kgemb_update, virtual_extension  # noqa: F401
from repro_torch.core.federation import FederationEvent, FederationScheduler, NodeState  # noqa: F401,E501
