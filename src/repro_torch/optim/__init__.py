from repro_torch.optim.adamw import (
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    opt_state_logical,
)

__all__ = [
    "OptState", "adamw_init", "adamw_update", "clip_by_global_norm",
    "cosine_schedule", "opt_state_logical",
]
