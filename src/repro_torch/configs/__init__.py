from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    INPUT_SHAPE_BY_NAME,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ServeConfig,
    TrainConfig,
)
from repro_torch.configs.registry import ARCHS, get_config, reduced  # noqa: F401
