"""lr step / warmup over the warm-up, then a cosine from lr to final_frac
lr over the steps to ``total``."""
import math


def rate(spec: dict):
    lr, warm, total = spec["lr"], spec["warmup"], spec["total"]
    final = spec.get("final_frac", 0.1)

    def f(step):
        if step < warm:
            return lr * min(max(step / max(warm, 1), 0.0), 1.0)
        frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
        return lr * (final + (1 - final) * 0.5 * (1 + math.cos(math.pi * frac)))

    return f
