from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    HEAD_DIMS,
    LAUNCHES,
    reset_launches,
    ssd_chunk_kernel_apply,
    ssd_chunks,
    ssd_chunks_plain,
)
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref, ssd_ref  # noqa: F401
