from repro_torch.serving.engine import (  # noqa: F401
    KGECandidateRanker,
    Request,
    ServingEngine,
)
from repro_torch.serving.tables import (  # noqa: F401
    FilterPack,
    TableVersion,
)
from repro_torch.serving.tier import (  # noqa: F401
    KGEServingTier,
    QueryRequest,
    TierOverloadError,
)
