"""Architecture configs of the dense family — counterpart of ``repro/configs``."""
from .base import (  # noqa: F401
    ArchConfig, LM_SHAPES, NOT_PORTED, Shape,
    all_configs, get_config, reduced, register,
)
