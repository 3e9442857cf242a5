from repro_torch.models.model import (  # noqa: F401
    CausalLM,
    init_params,
    lm_params_from_numpy,
)
