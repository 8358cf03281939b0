from repro_torch.optim.optimizers import (
    Optimizer,
    sgd,
    adam,
    adamw,
    apply_updates,
    global_norm,
    clip_by_global_norm,
)
from repro_torch.optim.schedules import constant, cosine, warmup_cosine

__all__ = [
    "Optimizer",
    "sgd",
    "adam",
    "adamw",
    "apply_updates",
    "global_norm",
    "clip_by_global_norm",
    "constant",
    "cosine",
    "warmup_cosine",
]
