from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, shape_by_name
from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "shape_by_name",
           "ARCH_IDS", "all_configs", "get_config"]
