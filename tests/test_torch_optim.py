"""The port's optimizers against the reference's, on the CPU: 3 steps on the
same seeded numpy params and gradients, within 1e-6 absolute (float32
arithmetic in the same order; XLA may fuse a multiply-add where PyTorch
rounds twice)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim

SHAPES = {"a/w": (3, 4), "a/b": (4,), "c": (2, 3, 5)}

OPTIMIZERS = {
    "sgd": dict(),
    "sgd_momentum": dict(momentum=0.9),
    "sgd_nesterov": dict(momentum=0.9, nesterov=True),
    "adam": dict(),
    "adamw": dict(weight_decay=0.05),
}


def _make(name, lib):
    kw = OPTIMIZERS[name]
    return getattr(lib, name.split("_")[0])(**kw)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_steps_match_reference(name):
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [
        {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
        for _ in range(3)
    ]
    lr = 0.05
    jopt, opt = _make(name, joptim), _make(name, optim)

    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = opt.init(tp)
    for g in grads:
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, jnp.float32(lr))
        jp = joptim.apply_updates(jp, ju)
        tu, ts = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, lr)
        tp = optim.apply_updates(tp, tu)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6, err_msg=k)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    g = {k: (10 * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
    for max_norm in (1.0, 1e3):
        jc, jn = joptim.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        tc, tn = optim.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in SHAPES:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=0, atol=1e-6)


def test_schedules_match_reference():
    for step in (0, 1, 5, 50, 99, 150):
        for j, t in (
            (joptim.constant(0.1), optim.constant(0.1)),
            (joptim.cosine(0.1, 100), optim.cosine(0.1, 100)),
            (joptim.warmup_cosine(0.1, 10, 100), optim.warmup_cosine(0.1, 10, 100)),
        ):
            np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6)
