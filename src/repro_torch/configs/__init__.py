from .base import (HybridLayout, ModelConfig, MoEConfig, SSMConfig, XLSTMConfig, ShapeConfig,
                   SHAPES, shape_grid)
from .registry import ARCHS, get_config, reduced_config

__all__ = [
    "HybridLayout", "ModelConfig", "MoEConfig", "SSMConfig", "XLSTMConfig", "ShapeConfig",
    "SHAPES", "shape_grid", "ARCHS", "get_config", "reduced_config",
]
