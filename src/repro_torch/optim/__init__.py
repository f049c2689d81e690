from repro_torch.optim.optimizers import (Optimizer, adamw, sgd, apply_updates,
                                          global_norm, clip_by_global_norm,
                                          clip_by_global_norm_)
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine

__all__ = ["Optimizer", "adamw", "sgd", "apply_updates", "global_norm",
           "clip_by_global_norm", "clip_by_global_norm_", "constant",
           "cosine_decay", "warmup_cosine"]
