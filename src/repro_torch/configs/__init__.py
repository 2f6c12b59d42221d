"""Assigned-architecture configs (exact public dims) + shape regimes: the
port's own copy of ``repro.configs``."""
from .base import (
    ArchConfig,
    SHAPES,
    ShapeSpec,
    all_configs,
    get_config,
    skip_reason,
    supported_shapes,
)

__all__ = [
    "ArchConfig",
    "SHAPES",
    "ShapeSpec",
    "all_configs",
    "get_config",
    "skip_reason",
    "supported_shapes",
]
