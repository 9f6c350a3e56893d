from repro_torch.config.base import (
    SHAPES,
    ArchConfig,
    MambaConfig,
    MoEConfig,
    ShapeConfig,
    all_arch_ids,
    cell_is_runnable,
    get_config,
)

__all__ = ["SHAPES", "ArchConfig", "MambaConfig", "MoEConfig", "ShapeConfig", "all_arch_ids",
           "cell_is_runnable", "get_config"]
