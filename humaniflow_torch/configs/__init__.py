from . import paths
from .defaults import (
    HumaniflowConfig,
    OptimiseConfig,
    apply_overrides,
    get_humaniflow_cfg_defaults,
    get_optimise_cfg_defaults,
    load_optimise_config,
    load_config,
    save_config,
)

__all__ = [
    "paths",
    "HumaniflowConfig",
    "OptimiseConfig",
    "apply_overrides",
    "get_humaniflow_cfg_defaults",
    "get_optimise_cfg_defaults",
    "load_optimise_config",
    "load_config",
    "save_config",
]
