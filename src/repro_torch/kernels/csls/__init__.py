from repro_torch.kernels.csls.ops import (  # noqa: F401
    LAUNCHES,
    build_kernels,
    cosine_matrix,
    cosine_matrix_plain,
    csls_matrix,
    reset_launches,
    topk_means,
)
from repro_torch.kernels.csls.ref import (  # noqa: F401
    cosine_matrix_ref,
    csls_argmax_ref,
    csls_matrix_ref,
)
