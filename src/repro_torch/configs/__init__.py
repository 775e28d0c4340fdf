"""Arch registry: configs for the 10 assigned architectures + shape cells
(port of ``repro.configs``)."""
from repro_torch.configs.base import (ARCH_IDS, SHAPES,  # noqa: F401
                                      ArchConfig, ShapeCell, cells_for,
                                      get_arch, shape_by_name)
