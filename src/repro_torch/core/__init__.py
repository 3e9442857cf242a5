from repro_torch.core.distributed import committed_device, replica_devices  # noqa: F401
from repro_torch.core.faults import (  # noqa: F401
    ServeFault,
    ServeFaultError,
    ServeFaultPlan,
)
