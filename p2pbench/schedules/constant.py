"""A constant rate ``lr``."""


def program(spec: dict):
    from repro_torch.optim.schedules import constant

    return constant(spec["lr"])
