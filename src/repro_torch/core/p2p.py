"""P2P distributed training — Algorithm 1 of the paper, on one card.

The port of the reference's ``repro/core/p2p.py``. The reference runs each
peer in a ``shard_map`` slice of a TPU mesh; here the P peers are a stacked
leading dimension on one device. The global batch ``(P * b, ...)`` splits
into ``(P, b, ...)`` as ``P("data")`` splits it there, per-peer gradients
come from ``torch.func.vmap`` over ``grad(loss_fn)``, and the exchange
protocol's ``combine`` takes the ``(P, *shape)`` gradient bank, where the
reference all-gathers over the peer axis.

Two kinds of state, chosen by what the peers' mixes are:

* **Held once.** A sync protocol on the full graph gives every peer the
  same mix, so params and optimizer state are one copy, as the reference's
  replicated ``out_specs`` hold them; the per-peer gradients share it
  (``vmap`` with ``in_dims=(None, 0)``). Where the mix is the plain
  mean (``allgather_mean`` or ``psum_mean`` with an f32 wire, no EF, no
  clip, no adversary) the step takes one gradient of the peers' mean
  loss, the mean of their gradients, and makes no ``(P, *shape)`` bank
  (the reference, one peer per device, never holds one either).
* **A per-peer bank** (:class:`PeerBank`, ``{name: (P, *shape)}``). On a
  sparse overlay (ring, gossip, hierarchical, static) each peer's mix is
  its own row of the Metropolis–Hastings matrix, and under ``async`` each
  peer mixes its own fresh gradient with the others' stale ones, on any
  graph. The reference keeps each peer's params and optimizer state in its
  own mesh device's buffer there (its replicated ``out_specs`` return
  device 0's copy, but every device's next step reads its own); the bank's
  row r is mesh device r's copy, made explicit. :func:`peer_bank` makes a
  bank from one copy (what the reference's replicated ``in_specs`` hand
  every device) and :func:`peer_row` reads a peer's row back. Adam's step
  count stays one scalar: the peers step together.

Every registered protocol runs on this step on the full graph, and every
one that decomposes into per-edge messages (``allgather_mean``, ``qsgd``,
``topk``, ``trimmed_mean``, ``median``, ``async``) on a sparse overlay;
``psum_mean``, ``krum``, ``reduce_scatter`` and ``tree`` refuse a sparse
overlay with the reference's ``ValueError``. An
:class:`~repro_torch.core.robust.AdversarySpec` replaces its attackers'
rows of the gradient bank before EF and the exchange (``sign_flip``,
``scaled_noise``; ``stale_replay`` exists on the host cluster only and is
refused with the reference's ``ValueError``).

``Topology(cast_params_once=True)`` computes the forward and backward on a
bf16 copy of every f32 leaf with two or more dimensions, made once per
step, as the reference does; the gradients come back in bf16 and the
master params, the optimizer state and the 1-d leaves stay f32. The
reference's CNNs refuse it (a bf16 kernel against f32 images), and so do
the port's: it serves losses whose layers cast their input to the weight's
dtype.

The loss runs inside :func:`~repro_torch.models.cnn.f32_numerics`: no
TF32, deterministic cuDNN algorithms, whatever the caller's global flags.
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
    AllGatherMean,
    ExchangeContext,
    ExchangeProtocol,
    PsumMean,
    check_overlay,
    get_exchange,
)
from repro_torch.core.graph import PeerGraph, get_graph
from repro_torch.core.simulate import resolve_device
from repro_torch.models.cnn import f32_numerics
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm

Params = Dict[str, torch.Tensor]


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
    cast_params_once: bool = False  # one bf16 cast per step of every f32 leaf with ndim >= 2
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
    """The train-step carry: ``params`` and ``opt_state`` held once (a sync
    protocol on the full graph) or as per-peer banks (:class:`PeerBank`,
    made by :func:`peer_bank`), ``step`` an int, ``key`` the
    ``torch.Generator`` the stochastic codecs draw from (None when the
    protocol needs none), ``mailbox`` the protocol's carried state (None
    for sync protocols), ``ef`` the per-peer EF-SGD residual bank
    ``{name: (P, *shape)}`` or None.

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


class PeerBank(dict):
    """Every peer's copy of a params-shaped dict: ``{name: (P, *shape)}``,
    row r peer r's (the buffer the reference's mesh device r holds).

    A plain dict whose leaves happen to have P rows is one copy; only this
    type says that the first dimension is the peer's. The per-peer step
    refuses params or optimizer moments that are not a ``PeerBank``, and
    the step that holds params once refuses a ``PeerBank``."""

    @property
    def num_peers(self) -> int:
        return int(next(iter(self.values())).shape[0])


def _map_leaf_dicts(tree, names, fn):
    """``tree`` with every mapping keyed by ``names`` (params, SGD momentum,
    Adam's moments) replaced by ``fn(mapping)``; other leaves unchanged."""
    if not isinstance(tree, Mapping):
        return tree
    if set(tree) == names:
        return fn(tree)
    return {k: _map_leaf_dicts(v, names, fn) for k, v in tree.items()}


def peer_bank(params: Mapping[str, torch.Tensor], opt_state, num_peers: int):
    """One copy of params and optimizer state -> ``(PeerBank, opt_state)``
    for the per-peer step: every params-shaped dict of both (the params, SGD
    momentum, Adam's ``mu`` and ``nu``) becomes a :class:`PeerBank` of
    ``num_peers`` identical rows; other leaves (Adam's step count) stay as
    they are. The rows are copies, not views of the single copy."""
    if isinstance(params, PeerBank):
        raise ValueError("peer_bank takes one copy of the params; these are already a PeerBank")
    names = set(params)
    bank = lambda d: PeerBank(
        {k: v.unsqueeze(0).expand(num_peers, *v.shape).clone() for k, v in d.items()})
    return bank(params), _map_leaf_dicts(opt_state, names, bank)


def peer_row(tree, rank: int):
    """Peer ``rank``'s copy out of a :class:`PeerBank`, or of an optimizer
    state holding banks (its other leaves as they are)."""
    if isinstance(tree, PeerBank):
        return {k: v[rank] for k, v in tree.items()}
    if isinstance(tree, Mapping):
        return {k: peer_row(v, rank) for k, v in tree.items()}
    return tree


def _check_banks(params, opt_state, num_peers: int, banked: bool) -> None:
    """Params and the optimizer's params-shaped dicts are all banks of
    ``num_peers`` rows (``banked``) or none is."""
    names = set(params)
    found = [params]
    _map_leaf_dicts(opt_state, names, found.append)
    if not banked:
        if any(isinstance(d, PeerBank) for d in found):
            raise ValueError(
                "this step holds params and optimizer state once (a sync protocol "
                "on the full graph); it got a PeerBank"
            )
        return
    for d in found:
        if not isinstance(d, PeerBank):
            raise ValueError(
                "this step keeps a per-peer bank of params and optimizer state (a "
                "sparse overlay or the async protocol); make one from a single copy "
                "with peer_bank(params, opt_state, num_peers)"
            )
        if d and d.num_peers != num_peers:
            raise ValueError(f"a PeerBank of {d.num_peers} rows for a {num_peers}-peer step")


def _merge_leaf_states(template, names, parts):
    """One optimizer state from ``parts``, ``[(leaf name, that leaf's new
    state)]``, laid out as ``template``: each params-shaped dict gathers its
    leaves from the parts, a shared leaf (Adam's step count, the same in
    every part) comes from the last part."""
    if not isinstance(template, Mapping):
        return parts[-1][1] if parts else template
    if set(template) == names:
        return {k: part[k] for k, part in parts}
    return {key: _merge_leaf_states(template[key], names, [(k, part[key]) for k, part in parts])
            for key in template}


def _donate_into(old, new, name):
    """``new`` (one leaf's new optimizer state) with each of its
    params-shaped ``{name: tensor}`` dicts written into the tensor at the
    same place in ``old`` and holding that tensor; shared leaves (Adam's
    step count) are left as they are."""
    if not isinstance(new, Mapping):
        return new
    if set(new) == {name} and torch.is_tensor(new[name]):
        return {name: old[name].copy_(new[name])}
    return {key: _donate_into(old[key], val, name) for key, val in new.items()}


def _update_by_leaf(optimizer: Optimizer, grads, opt_state, params, lr, donate: bool = False):
    """``optimizer.update`` and ``apply_updates`` one leaf at a time ->
    (new params, new optimizer state). Each gradient leaf is popped from
    ``grads`` (the caller's dict, emptied) as it is used, so besides the
    state at most one leaf's gradient, update and moments are alive. The
    optimizers are leafwise, so the arithmetic is that of one call over
    the dict, bit for bit. ``donate``: each leaf's new param and moments
    are written into the old tensors (the old state is consumed), so the
    new state takes no memory beside the old one."""
    names = set(params)
    new_params, parts = {}, []
    for k in list(grads):
        one = {k: grads.pop(k)}
        sub = _map_leaf_dicts(opt_state, names, lambda d, k=k: {k: d[k]})
        updates, part = optimizer.update(one, sub, {k: params[k]}, lr)
        new = apply_updates({k: params[k]}, updates)[k]
        if donate:
            new, part = params[k].copy_(new), _donate_into(sub, part, k)
        new_params[k] = new
        parts.append((k, part))
    return new_params, _merge_leaf_states(opt_state, names, parts)


# The profiler ranges of one train step, outermost first: the whole call,
# then its three stages in order (the host cluster's ``StageMetrics`` names
# its stages alike). The fused plain mean has no exchange.
STEP_SPANS = ("repro_torch.step", "repro_torch.step.compute_gradients",
              "repro_torch.step.exchange", "repro_torch.step.model_update")


def _span(name: str, step=None):
    """A host range ``name`` of ``torch.profiler`` around a ``with`` block,
    carrying ``step`` as its input where that is a host int or a tuple of
    them (a tensor step is left out: reading it would sync). The range has the profiler's
    function scope, not ``record_function``'s user scope: the profiler
    projects a user range onto the card as an activity that spans the
    kernels launched inside it, idle gaps included, so a trace's device
    work would count the range itself. A trace tells this range's kernels
    by their launches, which lie inside it on the host. With no profiler
    listening the range is one call on enter and one on exit: it neither
    syncs the device nor reads a tensor."""
    if isinstance(step, tuple):
        args = (tuple(int(v) for v in step),)
    else:
        args = ((int(step),),) if isinstance(step, (int, np.integer)) else ()
    return torch._C._profiler._RecordFunctionFast(name, *args)


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
    donate: bool = False,
    device: Any = "cuda",
):
    """Returns ``step(train_state, batch) -> (train_state, metrics)``.

    ``batch`` is a dict of tensors with a leading global batch of
    ``num_peers * b`` rows; peer r takes rows ``[r*b, (r+1)*b)``. Per peer:
    ``accum_steps`` micro-rounds of ``grad(loss_fn)`` averaged in f32 (on
    bf16 compute params under ``cast_params_once``), the ``grad_clip``
    global-norm clip, EF re-injection (when ``topo.ef`` or the state
    carries a residual bank; a missing bank starts at zero), then the
    protocol's ``combine`` / ``combine_ef`` over the stacked bank, the
    schedule's rate at ``state.step`` and the optimizer. ``adversary``
    replaces the seeded attacker ranks' rows of the bank (after the clip,
    before EF and the exchange) with their poisoned gradients, so every
    consumer and the protocol's estimator see them; ``scaled_noise`` draws
    from ``state.key``. ``metrics`` holds the loss averaged over peers,
    each peer's gradient norm before the clip (0 when off) and aux, as
    ``(P,)`` tensors, and the rate.

    Where the protocol's combine is the plain mean of the bank
    (``allgather_mean`` or ``psum_mean`` on the full graph with
    ``exchange_dtype`` float32, no EF and no residual in the state, no
    clip, no adversary), the step takes ``grad`` of the peers' mean loss
    (``vmap`` of ``loss_fn`` over the peers inside it) instead: the mean
    of their gradients, summed in another order, with no bank (at an LM's
    full width the bank is P copies of the params). Where the loss
    computes in bf16 (``cast_params_once``, or a model that casts its
    weights, as the LMs do), a weight's gradient then comes out of one
    bf16 product over all the peers' rows: their sum rounded to bf16
    once, where the bank rounds each peer's and takes the mean in f32.
    The two agree within that rounding (``tests/test_torch_p2p_mean.py``
    holds a reduced bf16 gemma2-2b to it).

    On a sparse overlay and under ``async`` the state's params and
    optimizer moments are :class:`PeerBank` banks (:func:`peer_bank`), and each
    peer steps its own row with its own mix; a single copy raises
    ``ValueError``, as a ``PeerBank`` does on the full graph's sync step.
    ``async`` needs the state's mailbox (:func:`init_mailbox`).

    ``donate=True`` consumes the state, as JAX's ``donate_argnums`` does:
    the step writes the new params and optimizer moments into the state's
    own tensors, so that a caller holding the old state sees the new
    values. At an LM's full width the functional update's new state beside
    the old one does not fit one card (gemma2-2b: 31 GB each).

    Runs on ``device``, by default ``"cuda"``; without a card it raises
    unless the caller passes ``device="cpu"``. The state's params must lie
    there already; the batch is moved there.
    """
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())  # as tensors report it
    protocol = topo.protocol()
    ctx = exchange_context(topo, num_peers=num_peers)
    banked = protocol.is_async or ctx.mixing is not None  # each peer's mix differs
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
    lead = 1 if banked else 0

    def compute_params(params):
        """The params the loss sees: under ``cast_params_once`` a bf16 copy
        of every f32 leaf with two or more dimensions (per peer)."""
        if not topo.cast_params_once:
            return dict(params)  # vmap's pytree takes a dict subclass for a leaf
        return {k: p.to(torch.bfloat16) if p.dtype == torch.float32 and p.dim() - lead >= 2
                else p for k, p in params.items()}

    def micro_rounds(fn, params, batch, dim: int):
        """``fn(params, batch) -> (grads, loss, aux)`` over ``accum_steps``
        micro-rounds, each leaf of the batch cut along ``dim``: the grads
        (in f32), loss and aux averaged over them; one round is ``fn``."""
        if rounds == 1:
            return fn(params, batch)
        micro = {k: v.unflatten(dim, (rounds, v.shape[dim] // rounds)) for k, v in batch.items()}
        for i in range(rounds):
            g, l, a = fn(params, {k: v.select(dim, i) for k, v in micro.items()})
            if not i:
                grads = {k: torch.zeros_like(x, dtype=torch.float32) for k, x in g.items()}
                loss = aux = l.new_zeros(l.shape, dtype=torch.float32)
            grads = {k: grads[k] + g[k].to(torch.float32) / rounds for k in grads}
            loss, aux = loss + l / rounds, aux + a / rounds
        return grads, loss, aux

    def one_grad(params, batch):
        grads, (loss, aux) = grad_fn(params, batch)
        return grads, loss, aux

    def peer_grads(params, batch):
        """One peer's (grads, loss, aux, grad norm); vmapped over the peers."""
        grads, loss, aux = micro_rounds(one_grad, params, batch, 0)
        if topo.grad_clip:
            grads, gnorm = clip_by_global_norm(grads, topo.grad_clip)
        else:
            gnorm = loss.new_zeros(())
        return grads, loss, aux, gnorm

    per_peer = torch.func.vmap(peer_grads, in_dims=(0 if banked else None, 0))
    plain_mean = (not banked and type(protocol) in (AllGatherMean, PsumMean)
                  and ctx.wire_dtype == torch.float32 and not topo.ef and not topo.grad_clip
                  and attackers is None)

    def mean_loss(params, batch):
        """The peers' mean loss, with each peer's (loss, aux) as ``(P,)``."""
        loss, aux = torch.func.vmap(loss_fn, in_dims=(None, 0))(params, batch)
        return loss.mean(), (loss, aux)

    mean_grad_fn = torch.func.grad_and_value(mean_loss, has_aux=True)

    def one_mean_grad(params, split):
        grads, (_, (loss, aux)) = mean_grad_fn(params, split)
        return grads, loss, aux

    def mean_grads(params, split):
        """One gradient of the peers' mean loss (their gradients' mean, in
        f32, averaged over the micro-rounds in f32) and each peer's loss
        and aux."""
        grads, loss, aux = micro_rounds(one_mean_grad, params, split, 1)
        return {k: g.to(torch.float32) for k, g in grads.items()}, loss, aux

    def combine_bank(grads, state):
        """The per-peer gradient bank -> (the mix each peer steps with, the
        new mailbox, the new EF residual bank): the attackers' rows
        poisoned, EF re-injected, the protocol's combine."""
        if attackers is not None:
            # Byzantine ranks publish a poisoned contribution: their
            # rows of the bank are replaced before the exchange
            poisoned = R.poison_gradients({k: g[attackers] for k, g in grads.items()},
                                          adversary, state.key, lead=1)
            grads = {k: g.to(torch.float32).index_copy(0, attackers, poisoned[k])
                     for k, g in grads.items()}
        ef = state.ef
        if topo.ef and ef is None:
            ef = init_ef({k: g[0] for k, g in grads.items()}, num_peers)
        if ef is not None:
            corrected = {k: g.to(torch.float32) + ef[k] for k, g in grads.items()}
            avg, local, mailbox = protocol.combine_ef(
                corrected, ctx, generator=state.key, state=state.mailbox
            )
            ef = {k: c - local[k].to(torch.float32) for k, c in corrected.items()}
            del corrected, local
        else:
            avg, mailbox = protocol.combine(grads, ctx, generator=state.key, state=state.mailbox)
        if not banked:  # full graph: every row of the bank is the same mix
            avg = {k: v[0] for k, v in avg.items()}
        return avg, mailbox, ef

    def step(state, batch):
        state = as_train_state(state)
        with _span(STEP_SPANS[0], state.step):
            off = [k for k, p in state.params.items() if p.device != device]
            if off:
                raise ValueError(f"params {off[:3]} are not on the step's device {device}")
            _check_banks(state.params, state.opt_state, num_peers, banked)
            split = {}
            for k, v in batch.items():
                v = torch.as_tensor(v).to(device)
                if v.shape[0] % num_peers:
                    raise ValueError(
                        f"batch[{k!r}] has {v.shape[0]} rows, not a multiple of "
                        f"{num_peers} peers"
                    )
                split[k] = v.reshape(num_peers, v.shape[0] // num_peers, *v.shape[1:])
            fused = plain_mean and state.ef is None
            with f32_numerics(), _span(STEP_SPANS[1]):
                if fused:
                    avg, loss, aux = mean_grads(compute_params(state.params), split)
                    gnorm = loss.new_zeros(loss.shape)
                else:
                    grads, loss, aux, gnorm = per_peer(compute_params(state.params), split)
            with torch.no_grad():
                mailbox, ef = state.mailbox, state.ef
                if not fused:
                    with _span(STEP_SPANS[2]):
                        avg, mailbox, ef = combine_bank(grads, state)
                    del grads  # the bank, P copies of the params, before the update's copies
                with _span(STEP_SPANS[3]):
                    lr = schedule(state.step)
                    params, opt_state = _update_by_leaf(optimizer, avg, state.opt_state,
                                                        state.params, lr, donate)
            if banked:
                names = set(params)
                params = PeerBank(params)
                opt_state = _map_leaf_dicts(opt_state, names, PeerBank)
            metrics = {"loss": loss.mean(), "grad_norm": gnorm, "lr": lr, "aux": aux}
            new_state = state.replace(
                params=params, opt_state=opt_state, step=state.step + 1, mailbox=mailbox, ef=ef,
            )
            return new_state, metrics

    return step
