"""Train and serve step builders for the LMs: the port's copy of the
reference's ``repro/train/steps.py``.

The port's LM keeps its weights in an ``nn.Module``; the steps take them
as a ``{name: tensor}`` dict (``TrainState.params``) and call the module
through ``torch.func.functional_call``, so that ``build_p2p_train_step``
can take per-peer gradients with ``torch.func.grad_and_value`` under
``torch.func.vmap``. The module the step calls is a skeleton on the
``meta`` device: the params come from the state.

On the card the full-sequence attention runs the flash kernels, forward and
backward (``kernels/flash_attention.py``). The SSD scan's kernel has no
backward, as the reference's Pallas scan has no gradient (ROADMAP.md,
reference behaviour 18): ``use_ssd_kernel`` defaults to False, and Mamba-2
trains through ``ssd_chunked``, as the reference's ``lm_loss`` does.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.func import functional_call

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.core.p2p import Topology, TrainState, build_p2p_train_step
from repro_torch.core.simulate import resolve_device
from repro_torch.models.transformer import LM
from repro_torch.optim import Optimizer


def lm_loss(
    model: LM,
    params: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    use_ssd_kernel: bool = False,
    z_loss: float = 1e-4,
):
    """Next-token cross-entropy plus the z-loss ``z_loss * mean(lse^2)``, on
    f32 logits of ``model`` run with ``params``. Returns (loss, ce).

    The reference adds ``router_aux_coef * aux`` for a MoE config; MoE is
    not ported, so such a config raises ``NotImplementedError``."""
    if cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name} is a MoE config, and MoE is not ported yet: ROADMAP.md, Queue 1, "
            "item 11 (moe_apply and its router aux loss)"
        )
    logits, _ = functional_call(model, params, (batch["tokens"], cfg),
                                {"use_ssd_kernel": use_ssd_kernel})
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"][..., None])[..., 0]
    ce = (lse - gold).mean()
    loss = ce
    if z_loss:
        loss = loss + z_loss * torch.square(lse).mean()
    return loss, ce


def init_train_state(generator: torch.Generator, cfg: ModelConfig, optimizer: Optimizer, *,
                     device="cuda") -> TrainState:
    """A fresh LM's params (from ``generator``), the optimizer's state over
    them, step 0, and ``generator`` as the state's key (what the stochastic
    codecs draw from next)."""
    model = models.init_model(cfg, generator=generator, device=resolve_device(device))
    params = {k: p.detach() for k, p in model.named_parameters()}
    return TrainState(params=params, opt_state=optimizer.init(params), step=0, key=generator)


def build_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    topo: Topology,
    num_peers: int,
    schedule: Callable[[int], float],
    *,
    use_ssd_kernel: bool = False,
    device="cuda",
):
    """``step(state, batch) -> (state, metrics)``: ``build_p2p_train_step``
    over ``lm_loss``. ``batch`` holds ``tokens`` and ``labels``, (P * b, S)
    int64; peer r takes rows [r b, (r + 1) b). The step donates its state,
    as the reference's jitted step does: the new params and moments are
    written into the state's own tensors (``build_p2p_train_step``'s
    ``donate``; at full width a second state does not fit one card), so a
    caller that reads the old params after the step copies them first."""
    with torch.device("meta"):
        model = LM(cfg, generator=None, device="meta")  # a skeleton: params come from the state

    def loss_fn(params, batch):
        return lm_loss(model, params, batch, cfg, use_ssd_kernel=use_ssd_kernel)

    return build_p2p_train_step(loss_fn, optimizer, topo, num_peers, schedule, donate=True,
                                device=device)


def build_serve_step(cfg: ModelConfig):
    """``serve_step(model, state, token) -> (logits, new_state)``: one decode
    step of the port's LM, under ``torch.inference_mode()``. The port keeps
    the weights in the module, where the reference passes params."""

    def serve_step(model, state, token):
        with torch.inference_mode():
            return models.decode_step(model, state, token, cfg)

    return serve_step
