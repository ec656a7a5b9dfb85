from repro_torch.configs.base import (
    ModelConfig,
    get_config,
    get_smoke_config,
    list_archs,
    register,
    smoke_variant,
)

__all__ = [
    "ModelConfig",
    "get_config",
    "get_smoke_config",
    "list_archs",
    "register",
    "smoke_variant",
]
