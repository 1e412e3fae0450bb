from repro_torch.optim.adamw import (
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
)

__all__ = [
    "OptState", "adamw_init", "adamw_update", "clip_by_global_norm",
    "cosine_schedule",
]
