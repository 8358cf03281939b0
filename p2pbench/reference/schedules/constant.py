"""A constant rate ``lr``."""


def rate(spec: dict):
    return lambda step: float(spec["lr"])
