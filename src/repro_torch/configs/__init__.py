from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    all_configs,
    get_config,
    get_smoke_config,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "InputShape",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "all_configs",
    "get_config",
    "get_smoke_config",
]
