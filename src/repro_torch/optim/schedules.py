"""Learning-rate schedules (step -> lr), as in the reference's
``repro/optim/schedules.py``; steps and rates are Python numbers here."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: float(lr)


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        c = 0.5 * (1 + math.cos(math.pi * frac))
        return lr * (final_frac + (1 - final_frac) * c)

    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    cos = cosine(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        w = min(max(step / max(warmup, 1), 0.0), 1.0)
        return lr * w if step < warmup else cos(step - warmup)

    return f
