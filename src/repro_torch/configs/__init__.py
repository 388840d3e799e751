"""Assigned-architecture configs (public-literature sizes) + smoke variants —
the port's copy of the JAX package's `configs/`."""
from repro_torch.configs.base import ARCH_IDS, SHAPES, ArchConfig, MoEConfig, ShapeConfig, get_config

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "MoEConfig", "ShapeConfig", "get_config"]
