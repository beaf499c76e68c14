from .adamw import AdamWConfig, adamw_update, init_opt_state, lr_schedule
from .clip import clip_by_global_norm, global_norm

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "lr_schedule",
           "clip_by_global_norm", "global_norm"]
