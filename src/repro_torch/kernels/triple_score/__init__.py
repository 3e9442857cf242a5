from repro_torch.kernels.triple_score.ops import (  # noqa: F401
    LAUNCHES,
    SCORE_MODES,
    build_kernels,
    fused_ranks,
    fused_ranks_plain,
    pairwise_scores,
    pairwise_scores_plain,
    pairwise_topk,
    pairwise_topk_cap,
    pairwise_topk_plain,
    reset_launches,
)
from repro_torch.kernels.triple_score.ref import (  # noqa: F401
    fused_ranks_ref,
    pairwise_scores_ref,
)
