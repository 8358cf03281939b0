"""Adam: the moments' running means, bias-corrected at step t; the step is
lr mu_hat / (sqrt(nu_hat) + eps)."""
import torch


def zero_state(p):
    return torch.zeros_like(p), torch.zeros_like(p)


def update(g, state, lr: float, t: int, opt: dict):
    b1, b2, eps = opt.get("b1", 0.9), opt.get("b2", 0.999), opt.get("eps", 1e-8)
    mu, nu = state
    mu, nu = b1 * mu + (1 - b1) * g, b2 * nu + (1 - b2) * g * g
    return lr * (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t)) + eps), (mu, nu)
