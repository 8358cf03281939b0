"""Adam with bias correction."""


def program(opt: dict):
    from repro_torch.optim import adam

    return adam(opt.get("b1", 0.9), opt.get("b2", 0.999), opt.get("eps", 1e-8))


def first_gradient(opt_state, opt: dict) -> dict:
    """The first moment after one step is (1 - b1) times the gradient."""
    return {k: v / (1 - opt.get("b1", 0.9)) for k, v in opt_state["mu"].items()}
