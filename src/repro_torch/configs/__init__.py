from .base import (  # noqa: F401
    ModelConfig, ExecConfig, ShapeSpec, SHAPES,
    register, get_config, list_configs,
)
