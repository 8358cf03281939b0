"""The P2P step's bank-free mean (``build_p2p_train_step``), on the CPU.

Where the exchange is the plain f32 mean of the gradient bank
(``allgather_mean`` or ``psum_mean`` on the full graph, f32 wire, no EF,
clip or adversary), the step takes one gradient of
the peers' mean loss and never makes the ``(P, *shape)`` bank. That
gradient is the bank's mean: on a small MLP and on a reduced squeezenet1.1,
for ``accum_steps`` 1 and 2, the step hands the optimizer the mean of
``vmap(grad(loss))`` over the peers within f32 rounding (2e-6 of the
largest magnitude: the peers' and the tokens' contributions are summed in
another order), and the per-peer losses and aux are the same.

Every other configuration keeps the bank: the protocol's combine sees the
``(P, *shape)`` gradients, with a gradient clip, EF, an adversary, ``qsgd``,
the ring, ``async`` and a bf16 wire.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.core import compression as C
from repro_torch.core import p2p
from repro_torch.core import robust as R
from repro_torch.core.exchange import get_exchange
from repro_torch.core.simulate import cnn_loss
from repro_torch.configs import reduced
from repro_torch.models.transformer import LM
from repro_torch.optim import sgd
from repro_torch.train import init_train_state, lm_loss

torch.set_num_threads(2)  # the test workers share the CPU with each other

PEERS, LR = 4, 0.1


def mlp_params(seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32))
    return {"l1.w": r(16, 8), "l1.b": r(16), "l2.w": r(3, 16), "l2.b": r(3)}


def mlp_loss(p, b):
    h = torch.tanh(b["x"] @ p["l1.w"].T + p["l1.b"])
    o = h @ p["l2.w"].T + p["l2.b"]
    return ((o - b["y"]) ** 2).mean(), h.abs().mean()


def mlp_batch(rows, seed=1):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.standard_normal((rows, 8)).astype(np.float32)),
            "y": torch.from_numpy(rng.standard_normal((rows, 3)).astype(np.float32))}


def squeezenet():
    cfg = dataclasses.replace(get_config("squeezenet1.1"), image_size=8, image_channels=1,
                              num_classes=10)
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.requires_grad_(False)
    params = {k: v.clone() for k, v in model.named_parameters()}
    rng = np.random.default_rng(3)
    batch = {"images": torch.from_numpy(rng.standard_normal((PEERS * 4, 1, 8, 8)).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 10, PEERS * 4))}
    return (lambda p, b: cnn_loss(model, p, b["images"], b["labels"])), params, batch


def banked_mean(loss_fn, params, batch, rounds):
    """The banked computation: each peer's gradient (averaged over its
    micro-rounds), stacked, and their mean over the peers."""
    split = {k: v.reshape(PEERS, rounds, -1, *v.shape[1:]) for k, v in batch.items()}
    grad = torch.func.grad_and_value(loss_fn, has_aux=True)
    bank, losses, auxes = [], [], []
    for r in range(PEERS):
        g_sum, l_sum, a_sum = None, 0.0, 0.0
        for i in range(rounds):
            g, (l, a) = grad(params, {k: v[r, i] for k, v in split.items()})
            g_sum = g if g_sum is None else {k: g_sum[k] + g[k] for k in g}
            l_sum, a_sum = l_sum + l, a_sum + a
        bank.append({k: v / rounds for k, v in g_sum.items()})
        losses.append(l_sum / rounds)
        auxes.append(a_sum / rounds)
    mean = {k: torch.stack([b[k] for b in bank]).mean(dim=0) for k in params}
    return mean, torch.stack(losses), torch.stack(auxes)


class Recorder:
    """Records what the step hands the optimizer and every bank the
    protocols' combines see."""

    def __init__(self, monkeypatch):
        self.updates, self.banks = [], []
        update = p2p._update_by_leaf

        def record_update(optimizer, avg, *args):
            self.updates.append({k: v.clone() for k, v in avg.items()})
            return update(optimizer, avg, *args)

        monkeypatch.setattr(p2p, "_update_by_leaf", record_update)
        for name in ("allgather_mean", "psum_mean", "qsgd", "async"):
            cls = type(get_exchange(name))
            for method in ("combine", "combine_ef"):
                original = getattr(cls, method)

                def spy(self_, grads, *a, _original=original, **kw):
                    self.banks.append({k: tuple(g.shape) for k, g in grads.items()})
                    return _original(self_, grads, *a, **kw)

                monkeypatch.setattr(cls, method, spy)


def _case(kind):
    if kind == "mlp":
        params = mlp_params()
        return mlp_loss, params, mlp_batch(PEERS * 4)
    return squeezenet()


@pytest.mark.parametrize("exchange", ["allgather_mean", "psum_mean"])
@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("kind", ["mlp", "squeezenet"])
def test_bank_free_step_hands_the_optimizer_the_banks_mean(monkeypatch, kind, rounds, exchange):
    loss_fn, params, batch = _case(kind)
    want, losses, auxes = banked_mean(loss_fn, params, batch, rounds)
    rec = Recorder(monkeypatch)
    step = p2p.build_p2p_train_step(loss_fn, sgd(), p2p.Topology(exchange=exchange,
                                                                  accum_steps=rounds),
                                    PEERS, lambda s: LR, device="cpu")
    state = p2p.TrainState({k: v.clone() for k, v in params.items()}, sgd().init(params), 0, None)
    state, metrics = step(state, batch)
    assert rec.banks == []  # the protocol's combine never saw a bank
    (got,) = rec.updates
    for k, g in got.items():
        assert g.dtype == torch.float32 and g.shape == params[k].shape
        scale = float(want[k].abs().max())
        assert float((g - want[k]).abs().max()) <= 2e-6 * scale, k
    torch.testing.assert_close(metrics["aux"], auxes, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(metrics["loss"], losses.mean(), rtol=1e-6, atol=1e-7)
    assert torch.equal(metrics["grad_norm"], torch.zeros(PEERS))
    for k, p in state.params.items():  # plain SGD: p - lr g
        torch.testing.assert_close(p, params[k] - LR * got[k], rtol=0, atol=0)


KEEPS_THE_BANK = {  # name -> (Topology fields, adversary)
    "clip": (dict(grad_clip=0.5), None),
    "ef": (dict(ef=True), None),
    "adversary": ({}, dict(num=1, attack="sign_flip", scale=10.0, seed=1)),
    "qsgd": (dict(exchange="qsgd", qsgd=C.QSGDConfig(levels=7, bucket=16)), None),
    "ring": (dict(graph="ring"), None),
    "async": (dict(exchange="async", staleness=1), None),
    "bf16_wire": (dict(exchange_dtype="bfloat16"), None),
}


@pytest.mark.parametrize("name", sorted(KEEPS_THE_BANK))
def test_other_configurations_keep_the_bank(monkeypatch, name):
    fields, adversary = KEEPS_THE_BANK[name]
    topo = p2p.Topology(**fields)
    rec = Recorder(monkeypatch)
    params = mlp_params()
    step = p2p.build_p2p_train_step(
        mlp_loss, sgd(), topo, PEERS, lambda s: LR, device="cpu",
        adversary=None if adversary is None else R.AdversarySpec(**adversary))
    opt_state = sgd().init(params)
    mailbox = None
    if name in ("ring", "async"):
        if name == "async":
            mailbox = p2p.init_mailbox(params, PEERS, staleness=1)
        params, opt_state = p2p.peer_bank(params, opt_state, PEERS)
    state = p2p.TrainState(params, opt_state, 0, torch.Generator().manual_seed(0),
                           mailbox=mailbox)
    step(state, mlp_batch(PEERS * 2))
    assert rec.banks, f"{name}: the step made no gradient bank"
    for bank in rec.banks:
        assert {k: s[0] for k, s in bank.items()} == dict.fromkeys(mlp_params(), PEERS)


@pytest.mark.parametrize("rounds", [1, 2])
def test_bank_free_lm_step_at_bf16_compute_stays_within_one_rounding_of_the_bank(
        monkeypatch, rounds):
    """Reduced gemma2-2b (2 layers, tied embeddings, both softcaps) at its
    bf16 compute dtype: the LM casts each f32 weight to bf16 inside, so
    the bank-free step's weight gradient is the peers' sum out of one bf16
    product, rounded once, where the bank rounds each peer's and takes the
    mean in f32. Each leaf the step hands the optimizer agrees with the
    bank's mean within 2^-7 of the leaf's largest magnitude: one bf16
    rounding of the sum and one of each peer's (2^-9 relative each), and
    one bf16 ulp (2^-8) where an activation's gradient lands on the other
    side of a rounding; the losses agree within rtol 2^-8."""
    cfg = reduced(get_config("gemma2-2b"), num_layers=2)
    assert cfg.dtype == "bfloat16" and cfg.tie_embeddings and cfg.final_logit_softcap
    model = LM(cfg, generator=None, device="meta")
    loss_fn = lambda p, b: lm_loss(model, p, b, cfg)
    params = init_train_state(torch.Generator().manual_seed(0), cfg, sgd(), device="cpu").params
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size,
                                                               size=(PEERS * 2, 33)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, losses, _ = banked_mean(loss_fn, params, batch, rounds)
    rec = Recorder(monkeypatch)
    step = p2p.build_p2p_train_step(loss_fn, sgd(), p2p.Topology(accum_steps=rounds), PEERS,
                                    lambda s: LR, device="cpu")
    _, metrics = step(p2p.TrainState(dict(params), sgd().init(params), 0, None), batch)
    assert rec.banks == []
    (got,) = rec.updates
    assert got.keys() == want.keys()
    for k, g in got.items():
        assert g.dtype == torch.float32 and g.shape == params[k].shape
        err, scale = float((g - want[k]).abs().max()), float(want[k].abs().max())
        assert err <= 2**-7 * scale, (k, err, scale)
    torch.testing.assert_close(metrics["loss"], losses.mean(), rtol=2**-8, atol=0)
