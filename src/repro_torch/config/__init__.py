from repro_torch.config.base import (
    ArchConfig,
    MambaConfig,
    MoEConfig,
    all_arch_ids,
    get_config,
)

__all__ = ["ArchConfig", "MambaConfig", "MoEConfig", "all_arch_ids", "get_config"]
