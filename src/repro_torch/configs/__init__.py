from repro_torch.configs.base import (
    ModelConfig,
    get_config,
    get_smoke_config,
    list_archs,
    long_context_variant,
    register,
    smoke_variant,
)
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape, input_specs, shape_applicable

__all__ = [
    "ModelConfig",
    "get_config",
    "get_smoke_config",
    "list_archs",
    "register",
    "smoke_variant",
    "INPUT_SHAPES",
    "InputShape",
    "input_specs",
    "shape_applicable",
]
