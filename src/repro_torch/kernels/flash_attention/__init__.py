from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    HEAD_DIMS,
    LAUNCHES,
    flash_attention,
    reset_launches,
)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: F401
