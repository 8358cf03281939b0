"""Pluggable gradient-exchange protocols — the paper's §III-B as an API.

The port of the reference's ``repro/core/exchange.py``. One
:class:`ExchangeProtocol` subclass implements both execution paths plus its
wire-byte accounting:

* **device path** — :meth:`~ExchangeProtocol.combine` and
  :meth:`~ExchangeProtocol.combine_ef` run in the device train step
  (``core/p2p.py``), carrying the state :meth:`~ExchangeProtocol.init_state`
  makes (the ``async`` mailbox ring; None for sync protocols). On one card the P peers are a stacked leading
  dimension: gradients are a ``{name: (P, *shape)}`` bank, the reference's
  ``all_gather`` over the peer axis is that bank itself and its ``pmean`` a
  reduction over dim 0. Each returns the mixed gradient of every peer,
  ``{name: (P, *shape)}`` f32; on the full graph the P rows of a sync
  protocol are one tensor expanded, since every peer's mix is the same.
* **host path** — :meth:`~ExchangeProtocol.host_encode` /
  :meth:`~ExchangeProtocol.host_decode` serialize one peer's gradient for
  the :class:`~repro_torch.core.mailbox.HostMailbox`.
* **accounting** — :meth:`~ExchangeProtocol.wire_bytes_per_edge`, scaled
  by the overlay degree in :meth:`~ExchangeProtocol.wire_bytes`.

Gradients are ``{name: tensor}`` dicts in the port's layout. The lossy
codecs permute each leaf to the reference's layout
(``convert.to_jax_layout``) and flatten it before they quantize or select,
and visit the leaves in JAX's flatten order (``convert.jax_order``), so
their payloads are the reference's.

The sharded protocols (``reduce_scatter`` here, ``tree`` in
:mod:`repro_torch.core.tree`) move a :class:`~repro_torch.core.shard.ShardPlan`
buffer, and their combines repeat the reference's collectives on the
stacked bank in the reference's order: the ring's hops and the tree's
(level, child slot) sweeps, each partial rounded through the wire dtype
where the reference sends it, so in f32 they are the reference's bit for
bit. The robust protocols (``trimmed_mean``, ``median``, ``krum``) run the
estimators of :mod:`repro_torch.core.robust` on the bank rounded through
the wire dtype, over each peer's closed neighbourhood on a sparse overlay.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Callable, ClassVar, Dict, Mapping, Optional, Tuple, Type

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.convert import jax_order, to_jax_layout, to_torch_layout
from repro_torch.core import compression as C
from repro_torch.core import robust as R
from repro_torch.core.shard import ShardPlan
from repro_torch.kernels import qsgd as qsgd_kernels
from repro_torch.kernels import topk as topk_kernels

Grads = Mapping[str, torch.Tensor]


@dataclass(frozen=True)
class ExchangeContext:
    """Everything a protocol needs besides the gradients themselves.

    ``graph`` is the resolved :class:`~repro_torch.core.graph.PeerGraph`;
    ``mixing`` its Metropolis–Hastings matrix ``W`` as a ``(P, P)`` array,
    or ``None`` for the full graph, where the weights are uniformly ``1/P``
    and the update keeps the plain-mean arithmetic. The device path mixes
    in float32, as the reference does.
    """

    num_peers: int = 1
    wire_dtype: torch.dtype = torch.float32
    qsgd: Optional[C.QSGDConfig] = None
    topk_frac: float = 0.01
    staleness: int = 1  # async: consume banks published K steps ago
    graph: Any = None
    mixing: Any = None
    # robust-aggregation knobs (see repro_torch.core.robust); a parameterized
    # protocol spec ("trimmed_mean:0.25", "krum:3") overrides these
    trim_frac: float = 0.0  # trimmed_mean: fraction dropped from EACH end
    krum_m: int = 1  # krum: multi-Krum selection count
    krum_f: Optional[int] = None  # krum: assumed attackers (None = max tolerable)
    robust_clip: float = 0.0  # >0: per-peer norm clip before robust combine

    def __post_init__(self):
        gp = getattr(self.graph, "num_peers", None)
        if gp is not None and gp != self.num_peers:
            raise ValueError(
                f"ExchangeContext(num_peers={self.num_peers}) does not match "
                f"its overlay graph, which was built for {gp} peers "
                f"({self.graph.describe()}); resolve the graph for the "
                f"actual peer count (get_graph(spec, num_peers))"
            )

    @property
    def degree(self) -> float:
        """Mean neighbor count of one peer — (P-1) when no graph is set."""
        if self.graph is not None:
            return float(self.graph.mean_degree)
        return float(max(self.num_peers - 1, 0))


def _mixing(ctx: ExchangeContext, peers: int, device) -> torch.Tensor:
    """The distinct mixes' weights ``(M, P)`` f32: on the full graph one
    row, ``1/P`` each, which every peer shares; else ``W``'s P rows."""
    if ctx.mixing is None:
        return torch.full((1, peers), 1.0 / peers, dtype=torch.float32, device=device)
    return torch.as_tensor(np.asarray(ctx.mixing, np.float32), device=device)


def _mix(reduce: Callable[[torch.Tensor], torch.Tensor], ctx: ExchangeContext,
         peers: int, device) -> torch.Tensor:
    """The distinct mixes ``reduce(w)``, stacked, one per row of
    ``_mixing``."""
    return torch.stack([reduce(w) for w in _mixing(ctx, peers, device)])


def _flat_banks(grads: Grads):
    """``(name, (P, n) f32 in the reference's layout, its leaf shape)`` for
    each leaf of a stacked bank, in JAX leaf order."""
    for name in jax_order(grads):
        g = to_jax_layout(grads[name], lead=1)
        yield name, g.reshape(g.shape[0], -1).to(torch.float32).contiguous(), g.shape[1:]


def _leaf(flat: torch.Tensor, jshape, lead: int) -> torch.Tensor:
    """A flat leaf (with ``lead`` leading dims) in the reference's layout ->
    the port's layout."""
    return to_torch_layout(flat.reshape(*flat.shape[:lead], *jshape), lead=lead)


class ExchangeProtocol(abc.ABC):
    """Gradient-exchange protocol: device combine, host codec, wire accounting."""

    name: ClassVar[str] = "?"  # set by @register_exchange
    is_async: ClassVar[bool] = False  # consumes stale mailbox state
    requires_key: ClassVar[bool] = False  # needs random numbers (stochastic codec)
    decomposes_per_edge: ClassVar[bool] = True  # False: fused collective
    requires_full_graph: ClassVar[bool] = False  # True: refuses sparse overlays
    sharded: ClassVar[bool] = False  # True: shards, not whole gradients, on the wire
    lossy: ClassVar[bool] = False  # True: codec drops information (EF applies)
    hierarchical: ClassVar[bool] = False  # True: multi-level tree reduce

    def prepare(self, device: torch.device) -> None:
        """Build what the codec launches on ``device`` before the first step,
        so stage timings measure work, not compilation."""

    # -- device path ---------------------------------------------------------
    def init_state(self, grads_like: Grads, ctx: ExchangeContext):
        """Per-protocol carried state (the async mailbox ring); None if none."""
        return None

    @abc.abstractmethod
    def combine(self, grads: Grads, ctx: ExchangeContext, *, generator=None, state=None):
        """``{name: (P, *shape)}`` bank -> (every peer's mixed gradient
        ``{name: (P, *shape)}`` f32, new state). Sync protocols pass
        ``state`` through untouched."""

    def combine_ef(self, grads: Grads, ctx: ExchangeContext, *, generator=None, state=None):
        """Error-feedback variant: -> (mixed, local_image, new_state).

        ``local_image`` is the decoded image of each peer's own shipped
        contribution, ``(P, *shape)``: EF-SGD keeps ``grads - local_image``
        and adds it back before the next encode. Lossless protocols ship
        ``grads`` verbatim, so the residual stays zero; lossy codecs
        override."""
        avg, state = self.combine(grads, ctx, generator=generator, state=state)
        return avg, grads, state

    # -- host path -----------------------------------------------------------
    def host_encode(self, grads: Grads, ctx: ExchangeContext, *, generator=None):
        """One peer's gradient -> (wire payload, wire bytes)."""
        wire = {k: g.to(ctx.wire_dtype) for k, g in grads.items()}
        return wire, _tree_bytes(wire)

    def host_decode(self, payload, grads_like: Grads, ctx: ExchangeContext):
        """Wire payload -> this peer's dense fp32 gradient contribution."""
        return {k: g.to(torch.float32) for k, g in payload.items()}

    def host_combine(self, contribs, rank: int, ctx: ExchangeContext):
        """Protocol-specific host-path aggregation, or ``None`` for the
        default (graph-weighted mean) arithmetic.

        ``contribs`` is ``[(rank, decoded f32 gradient), ...]``, always
        including ``rank``'s own. Protocols whose estimator is not a
        weighted mean (the robust family) override this; the cluster's
        ``_update`` dispatches here first."""
        return None

    # -- accounting ----------------------------------------------------------
    def wire_bytes_per_edge(self, grads_like: Grads, ctx: ExchangeContext) -> int:
        """Payload bytes crossing ONE graph edge (one peer -> one neighbor)."""
        itemsize = torch.empty((), dtype=ctx.wire_dtype).element_size()
        return sum(int(np.prod(x.shape)) * itemsize for x in grads_like.values())

    def wire_bytes(self, grads_like: Grads, ctx: ExchangeContext) -> int:
        """Total bytes one peer moves per step: per-edge payload x degree."""
        return int(round(self.wire_bytes_per_edge(grads_like, ctx) * ctx.degree))

    def host_wire_bytes(self, grads_like: Grads, ctx: ExchangeContext) -> int:
        """Bytes one peer PUBLISHES on the host mailbox path per step: one
        edge-payload, whatever the degree (each neighbor pays its download)."""
        return self.wire_bytes_per_edge(grads_like, ctx)

    def describe(self) -> str:
        return (self.__doc__ or "").strip().splitlines()[0] if self.__doc__ else ""


def _tree_bytes(tree: Grads) -> int:
    return sum(x.numel() * x.element_size() for x in tree.values())


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type[ExchangeProtocol]] = {}


def check_overlay(protocol: ExchangeProtocol, graph) -> None:
    """Refuse a sparse overlay for a protocol that is one fused global
    collective (it does not decompose into per-edge messages) or that
    aggregates over all peers (``requires_full_graph``)."""
    if graph.is_full or graph.num_peers <= 1:
        return
    if not protocol.decomposes_per_edge or protocol.requires_full_graph:
        kind = (
            "a sharded global reduce-scatter"
            if protocol.requires_full_graph and protocol.decomposes_per_edge
            else "a fused global collective"
        )
        raise ValueError(
            f"exchange protocol {protocol.name!r} is {kind} "
            f"and only supports graph='full'; got {graph.describe()}"
        )


def register_exchange(name: str):
    """Class decorator: make a protocol reachable by name."""

    def deco(cls: Type[ExchangeProtocol]) -> Type[ExchangeProtocol]:
        if not issubclass(cls, ExchangeProtocol):
            raise TypeError(f"{cls!r} must subclass ExchangeProtocol")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def available_exchanges() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_exchange(spec: str) -> ExchangeProtocol:
    """Resolve a protocol spec: a registered name with an optional
    parameter suffix — ``"allgather_mean"``, ``"trimmed_mean:0.25"``,
    ``"krum:3"``, ``"tree:4"``. The parameter overrides the matching
    :class:`ExchangeContext` knob for this instance."""
    name, _, arg = str(spec).partition(":")
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown exchange protocol {spec!r}; registered protocols: "
            f"{', '.join(available_exchanges())}"
        ) from None
    if not arg:
        return cls()
    try:
        return cls(param=arg)
    except TypeError:
        raise ValueError(
            f"exchange protocol {name!r} does not take a ':' parameter "
            f"(got {spec!r})"
        ) from None


# ---------------------------------------------------------------------------
# Registered protocols
# ---------------------------------------------------------------------------


@register_exchange("allgather_mean")
class AllGatherMean(ExchangeProtocol):
    """Paper-faithful Algorithm 1: publish to own queue, consume all, average.

    Device image: the stacked bank in the wire dtype is the all-gather; the
    plain mean on the full graph, the Metropolis–Hastings mix ``W @ bank``
    under a sparse overlay.
    """

    def combine(self, grads, ctx, *, generator=None, state=None):
        avg = {}
        for k, g in grads.items():
            bank = g.to(ctx.wire_dtype).to(torch.float32)
            if ctx.mixing is None:
                avg[k] = bank.mean(dim=0).expand(bank.shape)
            else:
                w = torch.as_tensor(np.asarray(ctx.mixing, np.float32), device=g.device)
                avg[k] = torch.tensordot(w, bank, dims=([1], [0]))
        return avg, state


@register_exchange("psum_mean")
class PsumMean(ExchangeProtocol):
    """Beyond-paper optimized sync exchange: one fused all-reduce.

    Mathematically identical to allgather_mean, strictly less traffic; a
    ring all-reduce moves ``2 (P-1)/P x raw`` bytes per peer. The fused
    reduction is inherently global, so this protocol only supports the full
    overlay graph.
    """

    decomposes_per_edge = False

    def combine(self, grads, ctx, *, generator=None, state=None):
        if ctx.mixing is not None:
            raise ValueError(
                "psum_mean is a fused global all-reduce and only supports "
                "graph='full'; use allgather_mean (or qsgd/topk) for sparse "
                "overlays"
            )
        avg = {}
        for k, g in grads.items():
            # the reference's pmean in the wire dtype: peers summed in rank
            # order, each partial sum rounded to the wire dtype, then / P
            acc = g[0].to(ctx.wire_dtype)
            for p in range(1, g.shape[0]):
                acc = acc + g[p].to(ctx.wire_dtype)
            avg[k] = (acc / g.shape[0]).to(torch.float32).expand(g.shape)
        return avg, state

    def wire_bytes(self, grads_like, ctx) -> int:
        # Fused ring all-reduce: does not decompose into per-edge messages.
        raw = self.wire_bytes_per_edge(grads_like, ctx)
        P_ = max(ctx.num_peers, 1)
        return int(raw * 2 * (P_ - 1) / P_)


@register_exchange("qsgd")
class QSGDExchange(ExchangeProtocol):
    """QSGD-compressed exchange (paper §III-B.4): int8 levels + bucket norms.

    Stochastic quantization keeps the estimator unbiased; 8 + 32/bucket
    bits/element on the wire vs 32 uncompressed.
    """

    requires_key = True
    lossy = True

    def _cfg(self, ctx) -> C.QSGDConfig:
        return ctx.qsgd or C.QSGDConfig()

    def prepare(self, device: torch.device) -> None:
        if device.type == "cuda":
            qsgd_kernels.load_library()

    def _combine(self, grads, ctx, *, generator, want_local: bool):
        """Shared device path: per leaf, in JAX leaf order, one
        ``compression.draw_uniforms((P, nb, bucket), generator)`` call, one
        quantize of all P peers' buckets, the fused ``dequant_reduce`` of
        the P banks per distinct mix, and (EF) one dequantize of the P
        banks for the local images. ``uniforms[p]`` plays the role of the
        reference's ``uniform(split(fold_in(step_key, p), L)[leaf])``."""
        if generator is None:
            raise ValueError("qsgd exchange requires a torch.Generator")
        qcfg = self._cfg(ctx)
        avg, local = {}, {}
        for name, flat, jshape in _flat_banks(grads):
            peers, n = flat.shape
            nb = -(-n // qcfg.bucket)  # each peer's leaf padded to whole buckets
            buckets = F.pad(flat, (0, nb * qcfg.bucket - n)).reshape(peers * nb, qcfg.bucket)
            u = C.draw_uniforms((peers, nb, qcfg.bucket), generator)
            lev, nrm = qsgd_kernels.qsgd_quantize(
                buckets, u.reshape(peers * nb, qcfg.bucket), qcfg.levels
            )
            lev3, nrm2 = lev.view(peers, nb, qcfg.bucket), nrm.view(peers, nb)
            mixed = _mix(
                lambda w: C.dequant_reduce(lev3, nrm2, w, qcfg).reshape(-1)[:n],
                ctx, peers, flat.device,
            )
            avg[name] = _leaf(mixed, jshape, 1).expand(grads[name].shape)
            if want_local:
                dense = qsgd_kernels.qsgd_dequantize(lev, nrm, qcfg.levels)
                local[name] = _leaf(dense.view(peers, -1)[:, :n], jshape, 1)
        return avg, (local if want_local else None)

    def combine(self, grads, ctx, *, generator=None, state=None):
        avg, _ = self._combine(grads, ctx, generator=generator, want_local=False)
        return avg, state

    def combine_ef(self, grads, ctx, *, generator=None, state=None):
        avg, local = self._combine(grads, ctx, generator=generator, want_local=True)
        return avg, local, state

    def host_encode(self, grads, ctx, *, generator=None):
        if generator is None:
            raise ValueError("qsgd exchange requires a torch.Generator")
        payload = C.quantize_tree(grads, generator, self._cfg(ctx))
        return payload, C.payload_bytes(payload)

    def host_decode(self, payload, grads_like, ctx):
        dense = C.dequantize_tree(payload, self._cfg(ctx))
        return {k: dense[k].reshape(g.shape) for k, g in grads_like.items()}

    def wire_bytes_per_edge(self, grads_like, ctx) -> int:
        qcfg = self._cfg(ctx)
        total = 0
        for x in grads_like.values():
            nb = -(-int(np.prod(x.shape)) // qcfg.bucket)  # ceil: padded buckets
            total += nb * qcfg.bucket * 1 + nb * 4  # int8 levels + fp32 norms
        return total


@register_exchange("topk")
class TopKExchange(ExchangeProtocol):
    """Top-k sparsified exchange: each peer ships only its ``topk_frac``
    largest-magnitude gradient entries (values + int32 indices); receivers
    scatter-add and average. Deterministic, biased towards large
    coordinates.

    Select and scatter are the port's kernels (``kernels/topk.py``), whose
    selection is the reference's Pallas kernel's, tie rule included.
    """

    lossy = True

    @staticmethod
    def _k(n: int, frac: float) -> int:
        return max(1, min(n, int(round(n * frac))))

    def prepare(self, device: torch.device) -> None:
        if device.type == "cuda":
            topk_kernels.load_library()

    def _combine(self, grads, ctx, *, want_local: bool):
        """Shared device path: per leaf, one select over the peers' (P, n)
        bank, the peers' values rounded through the wire dtype, and one
        scatter of the bank into every distinct mix and (EF) every peer's
        own image, its entries unrounded as the reference keeps them."""
        avg, local, mixing = {}, {}, None
        for name, flat, jshape in _flat_banks(grads):
            peers, n = flat.shape
            if mixing is None:
                mixing = _mixing(ctx, peers, flat.device)
            k = self._k(n, ctx.topk_frac)
            vals, idx = topk_kernels.topk_select_pack_bank(flat, k)
            vbank = vals.to(ctx.wire_dtype).to(torch.float32)
            mixed, own = topk_kernels.topk_scatter_accum_bank(
                vbank, vals if want_local else None, idx, mixing, n)
            avg[name] = _leaf(mixed, jshape, 1).expand(grads[name].shape)
            if want_local:
                local[name] = _leaf(own, jshape, 1)
        return avg, (local if want_local else None)

    def combine(self, grads, ctx, *, generator=None, state=None):
        avg, _ = self._combine(grads, ctx, want_local=False)
        return avg, state

    def combine_ef(self, grads, ctx, *, generator=None, state=None):
        avg, local = self._combine(grads, ctx, want_local=True)
        return avg, local, state

    def host_encode(self, grads, ctx, *, generator=None):
        itemsize = torch.empty((), dtype=ctx.wire_dtype).element_size()
        payload, nbytes = {}, 0
        for name in jax_order(grads):
            g = to_jax_layout(grads[name])
            flat = g.reshape(-1).to(torch.float32).contiguous()
            k = self._k(flat.numel(), ctx.topk_frac)
            vals, idx = topk_kernels.topk_select_pack(flat, k)
            payload[name] = {
                "values": vals.to(ctx.wire_dtype),
                "idx": idx,
                "shape": np.asarray(g.shape, np.int64),
            }
            nbytes += k * (itemsize + 4)
        return payload, nbytes

    def host_decode(self, payload, grads_like, ctx):
        out = {}
        for name in jax_order(payload):
            p = payload[name]
            shape = tuple(int(d) for d in p["shape"])
            values = p["values"].to(torch.float32)
            dense = topk_kernels.topk_scatter_accum(
                values[None], p["idx"][None],
                torch.ones((1,), dtype=torch.float32, device=values.device),
                int(np.prod(shape)) if shape else 1,
            )
            out[name] = _leaf(dense, shape, 0)
        return out

    def wire_bytes_per_edge(self, grads_like, ctx) -> int:
        itemsize = torch.empty((), dtype=ctx.wire_dtype).element_size()
        return sum(
            self._k(int(np.prod(x.shape)), ctx.topk_frac) * (itemsize + 4)
            for x in grads_like.values()
        )


@register_exchange("async")
class StalenessMailbox(ExchangeProtocol):
    """Asynchronous staleness-K mailbox exchange (paper's "latest available
    gradient", generalized). The carried state is a ring of the last K
    published register banks, leaves shaped ``(K, P, *grad)`` f32; peers
    consume the bank published K steps ago (K=1 == the paper's staleness-1)
    while their own contribution is always fresh.

    On the stacked bank: the fresh bank rounds through the wire dtype into
    the ring; peer r mixes the oldest bank's other rows (the plain mean, or
    ``W[r]``) with its own fresh gradient; the ring rolls by one. The host
    path ships the dense gradient (the base class's codec).
    """

    is_async = True

    def init_state(self, grads_like, ctx):
        K = max(1, int(ctx.staleness))
        return {
            k: torch.zeros((K, ctx.num_peers, *g.shape), dtype=torch.float32, device=g.device)
            for k, g in grads_like.items()
        }

    def combine(self, grads, ctx, *, generator=None, state=None):
        if state is None:
            raise ValueError(
                "async exchange requires mailbox state; initialize the train "
                "state with init_mailbox(...) or ExchangeProtocol.init_state(...)"
            )
        avg, new_state = {}, {}
        for k, g in grads.items():
            ring, own = state[k], g.to(torch.float32)
            oldest = ring[0]  # the bank published K steps ago, (P, *shape)
            peers = oldest.shape[0]
            if ctx.mixing is None:
                others = oldest.sum(0) - oldest  # row r: every row but r
                avg[k] = (others + own) / peers
            else:
                w = _mixing(ctx, peers, g.device)
                diag = torch.diagonal(w).reshape(peers, *([1] * (g.dim() - 1)))
                mixed = torch.tensordot(w, oldest, dims=([1], [0]))
                avg[k] = (mixed - diag * oldest) + diag * own
            fresh = g.to(ctx.wire_dtype).to(torch.float32)
            new_state[k] = torch.cat([ring[1:], fresh[None]], dim=0)
        return avg, new_state


def _round_trip(x: torch.Tensor, wire: torch.dtype) -> torch.Tensor:
    """``x`` f32 rounded through the wire dtype, as a send of it arrives."""
    return x.to(wire).to(torch.float32)


@register_exchange("reduce_scatter")
class ReduceScatterMean(ExchangeProtocol):
    """Sharded mean: ring reduce-scatter + allgather over contiguous shards.

    The LambdaML/SPIRT pattern: the gradient dict flattens into one buffer
    (:class:`ShardPlan`), peer ``r`` ends up owning the fully-reduced shard
    ``r`` after ``P - 1`` ring hops, divides by ``P``, and an allgather of
    the owned shards reconstructs the global mean everywhere. Shards — not
    whole gradients — are the unit of exchange, so the per-edge payload is
    ``model / P``.

    On the stacked bank, shard ``j`` is summed as the ring sums it: peer
    ``j + 1``'s piece first, then each next peer's round the ring to peer
    ``j``, the partial rounded through the wire dtype before each hop; the
    mean shard is rounded once more for the allgather. The shard layout is
    global (shard ``r`` aggregates over all peers), so sparse overlays are
    refused.

    Host image: peers publish shard-addressed pieces to the mailbox, each
    owner aggregates only its shard and re-broadcasts it — P aggregators
    that run as parallel serverless invocations
    (``ServerlessExecutor.simulate_aggregation``), with Lambda memory sized
    from shard bytes instead of model bytes.
    """

    requires_full_graph = True
    sharded = True

    def plan(self, grads_like: Grads, ctx: ExchangeContext, *, lead: int = 0) -> ShardPlan:
        """The shard layout for this peer count — one shard per peer."""
        return ShardPlan.for_tree(grads_like, max(int(ctx.num_peers), 1), lead=lead)

    def _check_full(self, ctx: ExchangeContext):
        if ctx.mixing is not None:
            raise ValueError(
                "reduce_scatter shards are aggregated over ALL peers and "
                "the protocol only supports graph='full'; use "
                "allgather_mean (or qsgd/topk) for sparse overlays"
            )

    def _bank_buffer(self, grads: Grads, ctx: ExchangeContext):
        """The plan and every peer's padded f32 buffer ``(P, padded)``."""
        peers = next(iter(grads.values())).shape[0]
        if peers != int(ctx.num_peers):
            raise ValueError(
                f"the gradient bank stacks {peers} peers, the context "
                f"expects {ctx.num_peers}"
            )
        plan = self.plan(grads, ctx, lead=1)
        return plan, plan.flatten(grads, lead=1).to(torch.float32)

    # -- device path ---------------------------------------------------------
    def combine(self, grads, ctx, *, generator=None, state=None):
        self._check_full(ctx)
        plan, flat = self._bank_buffer(grads, ctx)
        P = flat.shape[0]
        if P == 1:
            return plan.unflatten(flat, lead=1), state
        buf = flat.reshape(P, P, plan.shard_size)  # (peer, shard, S)
        owners = torch.arange(P, device=flat.device)
        # the partial of shard j starts at peer j + 1 and gains one peer's
        # piece per hop, rounded through the wire dtype as it is sent
        acc = buf[(owners + 1) % P, owners]
        for s in range(1, P):
            acc = _round_trip(acc, ctx.wire_dtype) + buf[(owners + 1 + s) % P, owners]
        mean = plan.unflatten(_round_trip(acc / P, ctx.wire_dtype).reshape(-1))  # the allgather
        return {k: mean[k].expand(grads[k].shape) for k in grads}, state

    # -- host path (shard-addressed) -----------------------------------------
    def host_encode_shard(self, shard_values: torch.Tensor, ctx: ExchangeContext, *,
                          generator=None):
        """One shard row -> (wire payload, wire bytes)."""
        wire = shard_values.to(ctx.wire_dtype)
        return wire, wire.numel() * wire.element_size()

    def host_decode_shard(self, payload: torch.Tensor, ctx: ExchangeContext) -> torch.Tensor:
        """Wire shard payload -> f32 shard row."""
        return payload.to(torch.float32)

    # -- accounting ----------------------------------------------------------
    def wire_bytes_per_edge(self, grads_like, ctx) -> int:
        """One shard crosses one edge: ``model / P`` bytes."""
        return self.plan(grads_like, ctx).shard_bytes(ctx.wire_dtype)

    def wire_bytes(self, grads_like, ctx) -> int:
        """Ring reduce-scatter + allgather: (P-1) shard sends per phase."""
        P_ = max(int(ctx.num_peers), 1)
        return 2 * (P_ - 1) * self.wire_bytes_per_edge(grads_like, ctx)

    def host_wire_bytes(self, grads_like, ctx) -> int:
        """Mailbox publishes per step: P-1 shard pieces (one per other
        owner) + this peer's re-broadcast aggregated shard."""
        P_ = max(int(ctx.num_peers), 1)
        return P_ * self.wire_bytes_per_edge(grads_like, ctx)


# ---------------------------------------------------------------------------
# Byzantine-robust protocols (estimators in repro_torch.core.robust)
# ---------------------------------------------------------------------------


class _RobustExchange(ExchangeProtocol):
    """Shared machinery of the robust family: the dense bank rounded through
    the wire dtype (the reference's ``all_gather`` of the wire-cast
    gradients), optionally norm-clipped per peer row (``ctx.robust_clip``),
    handed to the subclass estimator.

    Wire accounting is the dense ``allgather_mean``'s: order statistics and
    distance scores need every neighbour's dense gradient."""

    def _masks(self, ctx: ExchangeContext):
        """``(P, P)`` closed-neighbourhood rows, or None on the full graph
        (every peer is a member and every peer's aggregate is the same)."""
        if ctx.mixing is None:
            return None
        return np.asarray(ctx.graph.adjacency, dtype=bool) | np.eye(ctx.num_peers, dtype=bool)

    def _prepare(self, bank, ctx: ExchangeContext):
        if ctx.robust_clip > 0.0:
            return R.clip_bank_to_norm(bank, ctx.robust_clip)
        return bank

    def _aggregate(self, bank, mask, ctx: ExchangeContext):
        """``{name: (P, ...)}`` bank + membership mask (None: all rows) ->
        ``{name: leaf}`` aggregate."""
        raise NotImplementedError

    def combine(self, grads, ctx, *, generator=None, state=None):
        if self.requires_full_graph and ctx.graph is not None:
            check_overlay(self, ctx.graph)
        bank = self._prepare({k: _round_trip(g, ctx.wire_dtype) for k, g in grads.items()}, ctx)
        masks = self._masks(ctx)
        if masks is None:
            agg = self._aggregate(bank, None, ctx)
            return {k: agg[k].expand(grads[k].shape) for k in grads}, state
        rows = [self._aggregate(bank, m, ctx) for m in masks]
        return {k: torch.stack([row[k] for row in rows]) for k in grads}, state

    def host_combine(self, contribs, rank: int, ctx: ExchangeContext):
        """Robust aggregate over the contributions that arrived (the mailbox
        restricted consumption to graph edges, so the arrived set is the
        closed neighbourhood — possibly smaller under churn or rejected
        contributions), stacked in ascending rank."""
        ranked = sorted(contribs, key=lambda c: c[0])
        names = list(ranked[0][1])
        bank = {k: torch.stack([g[k].to(torch.float32) for _, g in ranked]) for k in names}
        return self._aggregate(self._prepare(bank, ctx), None, ctx)


@register_exchange("trimmed_mean")
class TrimmedMeanExchange(_RobustExchange):
    """Coordinate-wise trimmed mean: drop the ``f`` fraction of values from
    each end of every coordinate, mean the rest. ``trimmed_mean:f`` sets the
    trim; bare ``trimmed_mean`` reads ``ctx.trim_frac``. Survives up to
    ``f`` Byzantine peers per coordinate; ``f=0`` is the plain mean. On a
    sparse overlay each peer trims over its closed neighbourhood."""

    def __init__(self, param: Optional[str] = None):
        self.frac: Optional[float] = None
        if param is not None:
            self.frac = float(param)
            if not 0.0 <= self.frac < 0.5:
                raise ValueError(
                    f"trimmed_mean trim fraction must be in [0, 0.5), got {self.frac}"
                )

    def _trim(self, ctx) -> float:
        return ctx.trim_frac if self.frac is None else self.frac

    def _aggregate(self, bank, mask, ctx):
        frac = self._trim(ctx)
        return {
            k: R.masked_trimmed_mean(b, np.ones(b.shape[0], bool) if mask is None else mask, frac)
            for k, b in bank.items()
        }


@register_exchange("median")
class CoordinateMedianExchange(_RobustExchange):
    """Coordinate-wise median — the no-hyperparameter robust baseline with
    breakdown point 1/2 per coordinate; over the closed neighbourhood on a
    sparse overlay."""

    def _aggregate(self, bank, mask, ctx):
        return {
            k: R.masked_median(b, np.ones(b.shape[0], bool) if mask is None else mask)
            for k, b in bank.items()
        }


@register_exchange("krum")
class KrumExchange(_RobustExchange):
    """Krum / multi-Krum (Blanchard et al., 2017): score every contribution
    by its summed squared distance to its ``P - f - 2`` nearest peers,
    average the ``m`` lowest-scored gradients. ``krum`` selects 1;
    ``krum:m`` averages the top m. The distances need all contributions,
    so sparse overlays are refused (``requires_full_graph``)."""

    requires_full_graph = True

    def __init__(self, param: Optional[str] = None):
        self.m: Optional[int] = None
        if param is not None:
            self.m = int(param)
            if self.m < 1:
                raise ValueError(f"krum selection count must be >= 1, got {self.m}")

    def _select_count(self, ctx) -> int:
        return ctx.krum_m if self.m is None else self.m

    def _aggregate(self, bank, mask, ctx):
        flat, unflatten = R.flatten_bank(bank)
        m = min(self._select_count(ctx), int(flat.shape[0]))
        agg, _ = R.krum_select(flat, m=m, f=ctx.krum_f)
        out = unflatten(agg)
        return {k: out[k] for k in bank}
