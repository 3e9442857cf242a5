from repro_torch.kernels.sparse_update.ops import (  # noqa: F401
    LAUNCHES,
    SPARSE_MODES,
    build_kernels,
    fused_sparse_step,
    reset_launches,
    sparse_step_plain,
)
from repro_torch.kernels.sparse_update.ref import sparse_step_ref  # noqa: F401
