"""Architecture configs (one file per assigned architecture)."""

from .base import (ARCH_REGISTRY, SHAPES, SMOKE_REGISTRY, ArchConfig,  # noqa: F401
                   ShapeSpec, all_archs, get_arch)
