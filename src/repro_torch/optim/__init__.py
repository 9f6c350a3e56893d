from repro_torch.optim.optimizers import (
    OptimizerConfig,
    clip_by_global_norm,
    global_norm,
    lr_schedule,
    opt_init,
    opt_update,
)
from repro_torch.optim.specs import opt_state_specs

__all__ = [
    "OptimizerConfig", "clip_by_global_norm", "global_norm", "lr_schedule",
    "opt_init", "opt_update", "opt_state_specs",
]
