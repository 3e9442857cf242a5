from repro_torch.kge.data import KG, PAPER_KG_STATS, synthesize_universe  # noqa: F401
from repro_torch.kge.models import (  # noqa: F401
    MODEL_FAMILIES,
    KGEModel,
    init_kge,
    params_from_numpy,
    score_triples,
)
from repro_torch.kge.trainer import KGETrainer  # noqa: F401
from repro_torch.kge.eval import link_prediction, triple_classification_accuracy  # noqa: F401
