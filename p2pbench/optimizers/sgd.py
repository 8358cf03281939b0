"""SGD with heavy-ball momentum."""


def program(opt: dict):
    from repro_torch.optim import sgd

    return sgd(momentum=opt["momentum"])


def first_gradient(opt_state, opt: dict) -> dict:
    """The momentum after one step is the gradient."""
    return dict(opt_state)
