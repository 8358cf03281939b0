"""A linear warm-up over ``warmup`` steps to ``lr``, then a cosine to
``final_frac`` of it at ``total``."""


def program(spec: dict):
    from repro_torch.optim.schedules import warmup_cosine

    return warmup_cosine(spec["lr"], spec["warmup"], spec["total"], spec.get("final_frac", 0.1))
