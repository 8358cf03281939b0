"""Train and serve step builders for the LMs: the port's copy of the
reference's ``repro/train/steps.py``.

The port's LM keeps its weights in an ``nn.Module``; the steps take them
as a ``{name: tensor}`` dict (``TrainState.params``) and call the module
through ``torch.func.functional_call``, so that ``build_p2p_train_step``
can take per-peer gradients with ``torch.func.grad_and_value`` under
``torch.func.vmap``. The module the step calls is a skeleton on the
``meta`` device: the params come from the state.

On the card the full-sequence attention runs the flash kernels, forward and
backward (``kernels/flash_attention.py``). ``lm_loss`` applies the LM head
a chunk of tokens at a time (:class:`ChunkedHeadFn`): no (B, S, vocab)
f32 logits are held for the backward. The SSD scan's kernel has no
backward, as the reference's Pallas scan has no gradient (ROADMAP.md,
reference behaviour 18): ``use_ssd_kernel`` defaults to False, and Mamba-2
trains through ``ssd_chunked``, as the reference's ``lm_loss`` does.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch.func import functional_call

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.core.p2p import Topology, TrainState, build_p2p_train_step
from repro_torch.core.simulate import resolve_device
from repro_torch.optim import Optimizer


LOGITS_CHUNK_BYTES = 1 << 28  # bounds one chunk's f32 logits in the head's loss


def _chunk_rows(vocab: int) -> int:
    return max(1, LOGITS_CHUNK_BYTES // (4 * vocab))


def _logits(x, w, vocab: int, cap: float):
    """One chunk's logits as ``LM.unembed_logits`` makes them: the linear
    in x's dtype, the slice to ``vocab``, the f32 cast and the final
    softcap. Returns (logits, t = tanh(pre-cap logits / cap), or None
    without a softcap)."""
    z = F.linear(x, w)[:, :vocab].to(torch.float32)
    if not cap:
        return z, None
    t = torch.tanh(z.div_(cap))
    return t * cap, t


def _head_forward(x, w, labels, vocab: int, cap: float):
    wc = w.to(x.dtype)
    rows = _chunk_rows(vocab)
    lse, gold = [], []
    for s in range(0, x.shape[0], rows):
        z, _ = _logits(x[s:s + rows], wc, vocab, cap)
        lse.append(torch.logsumexp(z, dim=-1))
        gold.append(z.gather(-1, labels[s:s + rows, None])[:, 0])
    return torch.cat(lse), torch.cat(gold)


def _head_backward(x, w, labels, lse, g_lse, g_gold, vocab: int, cap: float):
    """(dx, dw) from each chunk's logits computed again: d logits =
    g_lse softmax + g_gold onehot(label), back through the softcap (in
    autograd's order), the f32 cast and the linear (in x's dtype); dw
    summed over the chunks in f32 and cast once to w's dtype. The chunk's
    f32 temporaries are updated in place: two are alive at a time."""
    wc = w.to(x.dtype)
    dx = torch.empty_like(x)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    rows = _chunk_rows(vocab)
    for s in range(0, x.shape[0], rows):
        xc, sl = x[s:s + rows], slice(s, s + rows)
        dz, t = _logits(xc, wc, vocab, cap)
        dz.sub_(lse[sl, None]).exp_().mul_(g_lse[sl, None])
        dz.scatter_add_(-1, labels[sl, None], g_gold[sl, None])
        if cap:  # d (tanh(z / cap) cap) / dz = cap (1 - t^2) / cap
            dz.mul_(cap).mul_(t.mul_(t).neg_().add_(1)).div_(cap)
            del t
        dz = F.pad(dz.to(x.dtype), (0, w.shape[0] - vocab))
        dx[sl] = dz @ wc
        dw.add_(dz.t() @ xc)
    return dx, dw.to(w.dtype)


def _per_peer(info, in_dims, fn, args, n):
    """A head function under ``vmap``: one call per peer (row of the
    vmapped dimension), outputs stacked; ``n`` leading args are tensors."""
    out = []
    for p in range(info.batch_size):
        row = [a if d is None else a.select(d, p) for a, d in zip(args[:n], in_dims[:n])]
        out.append(fn(*row, *args[n:]))
    return tuple(torch.stack(o) for o in zip(*out)), (0,) * len(out[0])


class ChunkedHeadFn(torch.autograd.Function):
    """(x (N, d), w (padded vocab, d), labels (N,)) -> each token's
    log-sum-exp and gold logit (N,) f32 over the logits ``LM.unembed_logits``
    would give, computed a chunk of ``LOGITS_CHUNK_BYTES`` of f32 logits at
    a time. Only x, w, the labels and lse are saved: the backward
    (:class:`ChunkedHeadBackwardFn`) computes each chunk's logits again.
    Under ``vmap`` with w shared the peers' tokens fold into one call;
    otherwise, and in the backward, each peer is one call."""

    @staticmethod
    def forward(x, w, labels, vocab, cap):
        return _head_forward(x, w, labels, vocab, cap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, labels, vocab, cap = inputs
        ctx.save_for_backward(x, w, labels, output[0])
        ctx.opts = (vocab, cap)

    @staticmethod
    def backward(ctx, g_lse, g_gold):
        x, w, labels, lse = ctx.saved_tensors
        g_lse = torch.zeros_like(lse) if g_lse is None else g_lse
        g_gold = torch.zeros_like(lse) if g_gold is None else g_gold
        dx, dw = ChunkedHeadBackwardFn.apply(x, w, labels, lse, g_lse, g_gold, *ctx.opts)
        return dx, dw, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, w, labels, vocab, cap):
        if in_dims[1] is None:  # one w: the peers' tokens are one batch
            xs, ls = (t.expand(info.batch_size, *t.shape) if d is None else t.movedim(d, 0)
                      for t, d in zip((x, labels), (in_dims[0], in_dims[2])))
            lse, gold = ChunkedHeadFn.apply(xs.flatten(0, 1), w, ls.flatten(0, 1), vocab, cap)
            return (lse.unflatten(0, (info.batch_size, -1)),
                    gold.unflatten(0, (info.batch_size, -1))), (0, 0)
        return _per_peer(info, in_dims, ChunkedHeadFn.apply, (x, w, labels, vocab, cap), 3)


class ChunkedHeadBackwardFn(torch.autograd.Function):
    """The head's backward as a function, so that it runs under ``vmap``
    (one call per peer: each peer's dw is its own). No second derivative."""

    @staticmethod
    def forward(x, w, labels, lse, g_lse, g_gold, vocab, cap):
        return _head_backward(x, w, labels, lse, g_lse, g_gold, vocab, cap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the chunked LM head has no second derivative")

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_peer(info, in_dims, ChunkedHeadBackwardFn.apply, args, 6)


def lm_loss(
    model: torch.nn.Module,
    params: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    moe_dispatch: str = "dense",
    use_ssd_kernel: bool = False,
    z_loss: float = 1e-4,
):
    """Next-token cross-entropy plus the z-loss ``z_loss * mean(lse^2)`` and,
    for a MoE config, ``router_aux_coef`` times the layers' router aux, on
    f32 logits of ``model`` run with ``params``. Returns (loss, ce). The
    model runs up to ``final_norm`` and :class:`ChunkedHeadFn` applies the
    head, a chunk of tokens at a time: the reference's value, without its
    (B, S, vocab) f32 logits. Whisper's batch carries ``frames`` (B, F, d)
    and the VLM's may carry ``patches`` (B, V, d): the model takes them, and
    the loss covers the S text positions."""
    extra = {k: batch[k] for k in ("frames", "patches") if k in batch}
    x, aux = functional_call(model, params, (batch["tokens"], cfg),
                             {"moe_dispatch": moe_dispatch, "use_ssd_kernel": use_ssd_kernel,
                              "head": False, **extra})
    w = params["embed"] if cfg.tie_embeddings else params["unembed.weight"]
    lse, gold = ChunkedHeadFn.apply(x.reshape(-1, x.shape[-1]), w, batch["labels"].reshape(-1),
                                    cfg.vocab_size, float(cfg.final_logit_softcap or 0.0))
    ce = (lse - gold).mean()
    loss = ce
    if z_loss:
        loss = loss + z_loss * torch.square(lse).mean()
    if cfg.num_experts:
        loss = loss + cfg.router_aux_coef * aux
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
    moe_dispatch: str = "dense",
    use_ssd_kernel: bool = False,
    adversary=None,
    device="cuda",
):
    """``step(state, batch) -> (state, metrics)``: ``build_p2p_train_step``
    over ``lm_loss`` (with ``adversary``'s Byzantine peers, if given). ``batch`` holds ``tokens`` and ``labels``, (P * b, S)
    int64; peer r takes rows [r b, (r + 1) b). The step donates its state,
    as the reference's jitted step does: the new params and moments are
    written into the state's own tensors (``build_p2p_train_step``'s
    ``donate``; at full width a second state does not fit one card), so a
    caller that reads the old params after the step copies them first.

    On CUDA it switches PyTorch's caching allocator to expandable segments,
    for the whole process from then on: with fixed segments the blocks
    freed between a full-width step's backward and its update stay split
    (gemma2-2b at 2 peers x 2048 tokens on an 80 GB card ran out of memory
    on its 4th step with 29 GiB reserved but unallocated)."""
    if resolve_device(device).type == "cuda":
        torch._C._accelerator_setAllocatorSettings("expandable_segments:True")
    with torch.device("meta"):  # a skeleton: params come from the state
        model = models.init_model(cfg, generator=None, device="meta")

    def loss_fn(params, batch):
        return lm_loss(model, params, batch, cfg, moe_dispatch=moe_dispatch,
                       use_ssd_kernel=use_ssd_kernel)

    return build_p2p_train_step(loss_fn, optimizer, topo, num_peers, schedule, donate=True,
                                adversary=adversary, device=device)


def build_serve_step(cfg: ModelConfig, *, moe_dispatch: str = "dense"):
    """``serve_step(model, state, token) -> (logits, new_state)``: one decode
    step of the port's LM, under ``torch.inference_mode()``. The port keeps
    the weights in the module, where the reference passes params."""

    def serve_step(model, state, token):
        with torch.inference_mode():
            return models.decode_step(model, state, token, cfg, moe_dispatch=moe_dispatch)

    return serve_step
