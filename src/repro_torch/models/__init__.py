from repro_torch.models.model import (  # noqa: F401
    CausalLM,
    init_params,
    lm_params_from_numpy,
    lm_params_to_numpy,
    lm_tree,
)
