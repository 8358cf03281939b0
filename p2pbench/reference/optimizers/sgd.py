"""SGD with heavy-ball momentum: m = momentum m + g; the step is lr m."""
import torch


def zero_state(p):
    return torch.zeros_like(p)


def update(g, m, lr: float, t: int, opt: dict):
    m = opt["momentum"] * m + g
    return lr * m, m
