from repro_torch.kernels.sparse_update.ops import (  # noqa: F401
    CLUSTER_BLOCKS,
    LAUNCHES,
    SPARSE_MODES,
    STEPS,
    build_kernels,
    fused_sparse_epoch,
    fused_sparse_step,
    reset_launches,
    sparse_epoch_plain,
    sparse_step_plain,
)
from repro_torch.kernels.sparse_update.ref import sparse_step_ref  # noqa: F401
