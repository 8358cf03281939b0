"""Pluggable gradient-exchange protocols — the paper's §III-B as an API.

The port of the reference's ``repro/core/exchange.py``, host path only so
far: one :class:`ExchangeProtocol` subclass serializes one peer's gradient
for the :class:`~repro_torch.core.mailbox.HostMailbox`
(:meth:`~ExchangeProtocol.host_encode` / :meth:`~ExchangeProtocol.host_decode`)
and accounts its wire bytes (:meth:`~ExchangeProtocol.wire_bytes_per_edge`,
scaled by the overlay degree in :meth:`~ExchangeProtocol.wire_bytes`).

Gradients are ``{name: tensor}`` dicts in the port's layout. The device
train step's ``combine`` comes with that step (ROADMAP.md, Queue 1,
"Device train step and top-k"); the protocols of the reference that are
not ported yet raise ``NotImplementedError`` from :func:`get_exchange`
naming their ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, ClassVar, Dict, Mapping, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core import compression as C
from repro_torch.kernels import qsgd as qsgd_kernels

Grads = Mapping[str, torch.Tensor]


@dataclass(frozen=True)
class ExchangeContext:
    """Everything a protocol needs besides the gradients themselves.

    ``graph`` is the resolved :class:`~repro_torch.core.graph.PeerGraph`;
    ``mixing`` its Metropolis–Hastings matrix ``W`` as a float64 ``(P, P)``
    array, or ``None`` for the full graph, where the weights are uniformly
    ``1/P`` and the update keeps the plain-mean arithmetic.
    """

    num_peers: int = 1
    wire_dtype: torch.dtype = torch.float32
    qsgd: Optional[C.QSGDConfig] = None
    graph: Any = None
    mixing: Any = None

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


class ExchangeProtocol:
    """Gradient-exchange protocol: host codec plus wire accounting."""

    name: ClassVar[str] = "?"  # set by @register_exchange
    requires_key: ClassVar[bool] = False  # needs random numbers (stochastic codec)
    lossy: ClassVar[bool] = False  # True: codec drops information (EF applies)

    def prepare(self, device: torch.device) -> None:
        """Build what the codec launches on ``device`` before the first step,
        so stage timings measure work, not compilation."""

    # -- host path -----------------------------------------------------------
    def host_encode(self, grads: Grads, ctx: ExchangeContext, *, generator=None):
        """One peer's gradient -> (wire payload, wire bytes)."""
        wire = {k: g.to(ctx.wire_dtype) for k, g in grads.items()}
        return wire, _tree_bytes(wire)

    def host_decode(self, payload, grads_like: Grads, ctx: ExchangeContext):
        """Wire payload -> this peer's dense fp32 gradient contribution."""
        return {k: g.to(torch.float32) for k, g in payload.items()}

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

# Protocols of the reference that the port does not have yet -> ROADMAP item.
_UNPORTED = {
    "psum_mean": "Device train step and top-k",
    "topk": "Device train step and top-k",
    "async": "Serverless and instance accounting",
    "reduce_scatter": "Robust, sharded and tree exchange",
    "tree": "Robust, sharded and tree exchange",
    "trimmed_mean": "Robust, sharded and tree exchange",
    "median": "Robust, sharded and tree exchange",
    "krum": "Robust, sharded and tree exchange",
}


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
    """Resolve a registered protocol name."""
    name, _, arg = str(spec).partition(":")
    if name in _UNPORTED:
        raise NotImplementedError(
            f"exchange protocol {name!r} is not ported yet: ROADMAP.md, "
            f"Queue 1, '{_UNPORTED[name]}'"
        )
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown exchange protocol {spec!r}; registered protocols: "
            f"{', '.join(available_exchanges())}"
        ) from None
    if arg:
        raise ValueError(
            f"exchange protocol {name!r} does not take a ':' parameter "
            f"(got {spec!r})"
        )
    return cls()


# ---------------------------------------------------------------------------
# Registered protocols
# ---------------------------------------------------------------------------


@register_exchange("allgather_mean")
class AllGatherMean(ExchangeProtocol):
    """Paper-faithful Algorithm 1: publish to own queue, consume all, average.

    Under a sparse overlay the cluster's update generalizes the mean to the
    Metropolis–Hastings neighbor mix; on the full graph the plain mean is
    kept.
    """


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
