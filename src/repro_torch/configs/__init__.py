"""Architecture configs: a copy of the JAX package's ``repro.configs``
(plain dataclasses, no JAX), kept field for field equal to it."""
from repro_torch.configs.base import (
    SHAPES, ArchConfig, MLAConfig, MoEConfig, RWKVConfig, ShapeSpec, SSMConfig,
    get_config, get_reduced, list_archs,
)

__all__ = [
    "SHAPES", "ArchConfig", "MLAConfig", "MoEConfig", "RWKVConfig",
    "ShapeSpec", "SSMConfig", "get_config", "get_reduced", "list_archs",
]
