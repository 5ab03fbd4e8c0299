"""Architecture configs — counterpart of ``repro/configs``."""
from .base import (  # noqa: F401
    ArchConfig, LM_SHAPES, MambaCfg, MLACfg, MoECfg, Shape,
    all_configs, get_config, reduced, register,
)
