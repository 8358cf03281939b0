"""P2P distributed training — Algorithm 1 of the paper, on one card.

The port of the reference's ``repro/core/p2p.py``. The reference runs each
peer in a ``shard_map`` slice of a TPU mesh; here the P peers are a stacked
leading dimension on one device. The global batch ``(P * b, ...)`` splits
into ``(P, b, ...)`` as ``P("data")`` splits it there, per-peer gradients
come from ``torch.func.vmap`` over ``grad(loss_fn)`` with the params
shared, and the exchange protocol's ``combine`` takes the ``(P, *shape)``
gradient bank, where the reference all-gathers over the peer axis.

On the full graph every peer's mix is the same, so the updated params and
optimizer state are held once, as the reference's replicated ``out_specs``
hold them. A sparse overlay, where each peer's mix differs, needs a
per-peer param bank and is refused (the reference keeps one copy there
too, which the port must not copy: ROADMAP.md, Queue 3 item 1). The
``async`` protocol is refused on this step for the same reason: its peers'
mixes differ on the full graph too, each peer's own gradient fresh and the
others' stale (Queue 3, reference behaviour 14). Its combine runs on the
stacked bank through :func:`exchange_gradients`, with the ring that
:func:`init_mailbox` makes.

Every registered protocol but ``async`` runs on this step on the full
graph, the robust (``trimmed_mean``, ``median``, ``krum``) and sharded
(``reduce_scatter``, ``tree``) ones included. An
:class:`~repro_torch.core.robust.AdversarySpec` replaces its attackers'
rows of the gradient bank before the exchange (``sign_flip``,
``scaled_noise``; ``stale_replay`` exists on the host cluster only and is
refused with the reference's ``ValueError``).

Not ported yet, each refused with ``NotImplementedError`` naming its
ROADMAP item: a sparse overlay or the ``async`` protocol on this step
(robust protocols on a sparse overlay included: their peers' mixes differ
too) and ``cast_params_once``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import compression as C
from repro_torch.core import robust as R
from repro_torch.core.exchange import (
    ExchangeContext,
    ExchangeProtocol,
    check_overlay,
    get_exchange,
)
from repro_torch.core.graph import PeerGraph, get_graph
from repro_torch.core.simulate import resolve_device, unported
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm

Params = Dict[str, torch.Tensor]

SPARSE_STEP = "Sparse-overlay device step"
BF16_PARAMS = "bf16 compute params"


@dataclass(frozen=True)
class Topology:
    """How the P2P system runs on the card (the reference's fields that mean
    something on one device)."""

    exchange: str = "allgather_mean"  # any name in exchange.available_exchanges()
    graph: Any = "full"  # peer overlay: name in graph.available_graphs() or a PeerGraph
    graph_seed: int = 0  # seeds stochastic overlays (gossip)
    qsgd: Optional[C.QSGDConfig] = None
    staleness: int = 1  # async: consume banks published K steps ago
    topk_frac: float = 0.01  # topk: fraction of entries shipped
    # Error feedback (EF-SGD): accumulate the compression residual
    # r <- (g + r) - decode(encode(g + r)) per peer and re-inject it next
    # step. No-op (residual identically zero) for lossless protocols.
    ef: bool = False
    # robust-aggregation knobs (see repro_torch.core.robust); a parameterized
    # spec (exchange="trimmed_mean:0.25" / "krum:3") overrides these
    trim_frac: float = 0.0  # trimmed_mean: fraction dropped from EACH end
    krum_m: int = 1  # krum: multi-Krum selection count
    krum_f: Optional[int] = None  # krum: assumed attackers (None = max)
    robust_clip: float = 0.0  # >0: per-peer norm clip before robust combine
    grad_clip: float = 0.0  # > 0: clip each peer's gradient to this global norm
    exchange_dtype: str = "float32"  # bfloat16 halves exchange wire bytes
    cast_params_once: bool = False  # one bf16 cast per step (not ported yet)
    # Gradient accumulation: split each peer's batch into `accum_steps`
    # sequential micro-rounds and average their gradients.
    accum_steps: int = 1

    def protocol(self) -> ExchangeProtocol:
        return get_exchange(self.exchange)

    def peer_graph(self, num_peers: int) -> PeerGraph:
        """Resolve the overlay for ``num_peers`` ranks via the registry."""
        return get_graph(self.graph, num_peers, seed=self.graph_seed)


def exchange_context(topo: Topology, *, num_peers: int) -> ExchangeContext:
    """The :class:`ExchangeContext` a protocol sees for ``topo``: the overlay
    resolved for ``num_peers`` with its float32 Metropolis–Hastings matrix,
    or ``mixing=None`` on the full graph (plain-mean arithmetic)."""
    graph = topo.peer_graph(num_peers)
    check_overlay(topo.protocol(), graph)
    mixing = (
        None if (graph.is_full or num_peers <= 1)
        else graph.mixing_matrix().astype(np.float32)
    )
    wire = getattr(torch, topo.exchange_dtype, None)
    if not isinstance(wire, torch.dtype):
        raise ValueError(f"exchange_dtype {topo.exchange_dtype!r} is not a torch dtype")
    return ExchangeContext(
        num_peers=num_peers, wire_dtype=wire, qsgd=topo.qsgd,
        topk_frac=topo.topk_frac, staleness=topo.staleness, graph=graph, mixing=mixing,
        trim_frac=topo.trim_frac, krum_m=topo.krum_m, krum_f=topo.krum_f,
        robust_clip=topo.robust_clip,
    )


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------


@dataclass
class TrainState:
    """The train-step carry: ``params`` and ``opt_state`` held once (full
    graph), ``step`` an int, ``key`` the ``torch.Generator`` the stochastic
    codecs draw from (None when the protocol needs none), ``mailbox`` the
    protocol's carried state (None for sync protocols), ``ef`` the per-peer
    EF-SGD residual bank ``{name: (P, *shape)}`` or None.

    ``state["params"]``, ``state.get("ef")`` and ``dict(state)`` work as on
    the reference's; the optional fields are present only when set."""

    params: Any
    opt_state: Any
    step: Any
    key: Any
    mailbox: Any = None
    ef: Any = None

    def __getitem__(self, name: str):
        if name not in self.keys():
            raise KeyError(name)
        return getattr(self, name)

    def get(self, name: str, default=None):
        if name not in _TRAIN_STATE_FIELDS:
            return default
        val = getattr(self, name)
        return default if (name in _OPTIONAL_STATE_FIELDS and val is None) else val

    def keys(self):
        return [
            f for f in _TRAIN_STATE_FIELDS
            if not (f in _OPTIONAL_STATE_FIELDS and getattr(self, f) is None)
        ]

    def __contains__(self, name) -> bool:
        return name in self.keys()

    def __iter__(self):
        return iter(self.keys())

    def replace(self, **updates) -> "TrainState":
        return dataclasses.replace(self, **updates)


_TRAIN_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(TrainState))
_OPTIONAL_STATE_FIELDS = ("mailbox", "ef")


def as_train_state(state) -> TrainState:
    """Accept a TrainState or a state dict with its fields."""
    if isinstance(state, TrainState):
        return state
    if isinstance(state, Mapping):
        extra = set(state) - set(_TRAIN_STATE_FIELDS)
        if extra:
            raise ValueError(
                f"train-state dict has entries TrainState cannot carry: "
                f"{sorted(extra)}; TrainState fields are {_TRAIN_STATE_FIELDS}"
            )
        return TrainState(
            params=state["params"],
            opt_state=state["opt_state"],
            step=state["step"],
            key=state["key"],
            mailbox=state.get("mailbox"),
            ef=state.get("ef"),
        )
    raise TypeError(f"expected TrainState or mapping, got {type(state)!r}")


def init_mailbox(grads_like: Mapping[str, torch.Tensor], num_peers: int, *,
                 staleness: int = 1) -> Params:
    """Zero staleness-K mailbox ring of the ``async`` protocol:
    ``{name: (K, P, *shape)}`` f32 on the leaves' device."""
    return get_exchange("async").init_state(
        grads_like, ExchangeContext(num_peers=num_peers, staleness=staleness)
    )


def init_ef(grads_like: Mapping[str, torch.Tensor], num_peers: int) -> Params:
    """Zero EF-SGD residual bank: ``{name: (P, *shape)}`` f32."""
    return {
        k: torch.zeros((num_peers, *g.shape), dtype=torch.float32, device=g.device)
        for k, g in grads_like.items()
    }


def exchange_gradients(grads, topo: Topology, generator=None, mailbox=None, *,
                       num_peers: Optional[int] = None):
    """``{name: (P, *shape)}`` bank -> (every peer's mixed gradient, new
    mailbox) via the registered protocol. ``num_peers``, when given, must
    match the bank's leading dimension."""
    peers = next(iter(grads.values())).shape[0]
    if num_peers is not None and num_peers != peers:
        raise ValueError(
            f"exchange_gradients got num_peers={num_peers} but the gradient "
            f"bank stacks {peers} peers"
        )
    ctx = exchange_context(topo, num_peers=peers)
    return topo.protocol().combine(grads, ctx, generator=generator, state=mailbox)


# ---------------------------------------------------------------------------
# Building the P2P train step
# ---------------------------------------------------------------------------


def build_p2p_train_step(
    loss_fn: Callable,  # (params, batch) -> (loss, aux), for ONE peer's batch
    optimizer: Optimizer,
    topo: Topology,
    num_peers: int,
    schedule: Callable[[int], float],
    *,
    adversary: Optional[R.AdversarySpec] = None,
    device: Any = "cuda",
):
    """Returns ``step(train_state, batch) -> (train_state, metrics)``.

    ``batch`` is a dict of tensors with a leading global batch of
    ``num_peers * b`` rows; peer r takes rows ``[r*b, (r+1)*b)``. Per peer:
    ``accum_steps`` micro-rounds of ``grad(loss_fn)`` averaged in f32, the
    ``grad_clip`` global-norm clip, EF re-injection (when ``topo.ef`` or the
    state carries a residual bank; a missing bank starts at zero), then the
    protocol's ``combine`` / ``combine_ef`` over the stacked bank, the
    schedule's rate at ``state.step`` and the optimizer. ``adversary``
    replaces the seeded attacker ranks' rows of the bank (after the clip,
    before EF and the exchange) with their poisoned gradients, so every
    consumer and the protocol's estimator see them; ``scaled_noise`` draws
    from ``state.key``. ``metrics`` holds
    the loss averaged over peers, each peer's gradient norm before the clip
    (0 when off) and aux, as ``(P,)`` tensors, and the rate.

    Runs on ``device``, by default ``"cuda"``; without a card it raises
    unless the caller passes ``device="cpu"``. The state's params must lie
    there already; the batch is moved there.
    """
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())  # as tensors report it
    if topo.cast_params_once:
        raise unported("cast_params_once", BF16_PARAMS)
    protocol = topo.protocol()
    ctx = exchange_context(topo, num_peers=num_peers)
    if ctx.mixing is not None:
        raise unported(
            f"a sparse overlay ({ctx.graph.describe()}) on the device step, "
            f"which needs a per-peer param bank,", SPARSE_STEP,
        )
    if protocol.is_async:
        raise unported(
            f"the {topo.exchange!r} protocol on the device step, where each peer "
            f"mixes its own fresh gradient and needs a per-peer param bank,", SPARSE_STEP,
        )
    if topo.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {topo.accum_steps}")
    attackers = None
    if adversary is not None and adversary.active:
        if adversary.attack == "stale_replay":
            raise ValueError(
                "stale_replay replays a previous epoch's wire payload and "
                "only exists on the host mailbox path (LocalP2PCluster); "
                "use sign_flip or scaled_noise on the device path"
            )
        attackers = torch.as_tensor(adversary.attackers(num_peers), dtype=torch.long,
                                    device=device)
    grad_fn = torch.func.grad_and_value(loss_fn, has_aux=True)
    rounds = topo.accum_steps

    def peer_grads(params, batch):
        """One peer's (grads, loss, aux, grad norm); vmapped over the peers."""
        if rounds > 1:
            micro = {k: v.reshape(rounds, v.shape[0] // rounds, *v.shape[1:])
                     for k, v in batch.items()}
            some = next(iter(params.values()))
            grads = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
            loss = aux = some.new_zeros((), dtype=torch.float32)
            for i in range(rounds):
                g, (l, a) = grad_fn(params, {k: v[i] for k, v in micro.items()})
                grads = {k: grads[k] + g[k].to(torch.float32) / rounds for k in grads}
                loss, aux = loss + l / rounds, aux + a / rounds
        else:
            grads, (loss, aux) = grad_fn(params, batch)
        if topo.grad_clip:
            grads, gnorm = clip_by_global_norm(grads, topo.grad_clip)
        else:
            gnorm = loss.new_zeros(())
        return grads, loss, aux, gnorm

    per_peer = torch.func.vmap(peer_grads, in_dims=(None, 0))

    def step(state, batch):
        state = as_train_state(state)
        off = [k for k, p in state.params.items() if p.device != device]
        if off:
            raise ValueError(f"params {off[:3]} are not on the step's device {device}")
        split = {}
        for k, v in batch.items():
            v = torch.as_tensor(v).to(device)
            if v.shape[0] % num_peers:
                raise ValueError(
                    f"batch[{k!r}] has {v.shape[0]} rows, not a multiple of "
                    f"{num_peers} peers"
                )
            split[k] = v.reshape(num_peers, v.shape[0] // num_peers, *v.shape[1:])
        grads, loss, aux, gnorm = per_peer(state.params, split)
        with torch.no_grad():
            if attackers is not None:
                # Byzantine ranks publish a poisoned contribution: their
                # rows of the bank are replaced before the exchange
                poisoned = R.poison_gradients({k: g[attackers] for k, g in grads.items()},
                                              adversary, state.key, lead=1)
                grads = {k: g.to(torch.float32).index_copy(0, attackers, poisoned[k])
                         for k, g in grads.items()}
            ef = state.ef
            if topo.ef and ef is None:
                ef = init_ef(state.params, num_peers)
            if ef is not None:
                corrected = {k: g.to(torch.float32) + ef[k] for k, g in grads.items()}
                avg, local, mailbox = protocol.combine_ef(
                    corrected, ctx, generator=state.key, state=state.mailbox
                )
                ef = {k: c - local[k].to(torch.float32) for k, c in corrected.items()}
            else:
                avg, mailbox = protocol.combine(
                    grads, ctx, generator=state.key, state=state.mailbox
                )
            # full graph: every row of the bank is the same mix
            avg = {k: v[0] for k, v in avg.items()}
            lr = schedule(state.step)
            updates, opt_state = optimizer.update(avg, state.opt_state, state.params, lr)
            params = apply_updates(state.params, updates)
        metrics = {"loss": loss.mean(), "grad_norm": gnorm, "lr": lr, "aux": aux}
        new_state = state.replace(
            params=params, opt_state=opt_state, step=state.step + 1, mailbox=mailbox, ef=ef,
        )
        return new_state, metrics

    return step
