"""Multi-level tree aggregation — hierarchical reduce through hub peers.

The port of the reference's ``repro/core/tree.py``. Flat aggregation
concentrates fan-in: under ``allgather_mean`` every peer downloads ``P - 1``
gradients per step, and under ``reduce_scatter`` every shard owner still
fans in ``P - 1`` pieces in one round. ``tree[:fanout]`` bounds it. Peers
form an implicit k-ary heap-indexed aggregation tree (:class:`TreePlan`):
rank 0 is the root, rank ``i``'s parent is ``(i - 1) // k``. One step runs
two sweeps:

* **up-sweep** — leaves send their gradient buffer; each hub adds its ≤ k
  children's partial sums to its own gradient and sends one partial up.
  The root holds the global sum and divides by ``P``.
* **down-sweep** — the mean relays root → leaves, one upload per hub.

Per-peer per-round fan-in is ``fanout`` instead of ``P - 1``; total wire
stays ``2 (P - 1)`` buffer messages. The buffer is the
:class:`~repro_torch.core.shard.ShardPlan`'s flattened padded buffer, and
:class:`TreeAggregate` subclasses ``reduce_scatter`` for its plan and
shard-wire codec.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.exchange import ReduceScatterMean, _round_trip, register_exchange


@dataclass(frozen=True)
class TreePlan:
    """Static k-ary heap-indexed aggregation tree over ``num_peers`` ranks.

    Rank ``i``'s parent is ``(i - 1) // fanout``; its children are
    ``fanout * i + 1 .. fanout * i + fanout`` (clipped to ``num_peers``).
    Level ``l`` spans ranks ``[(k^l - 1) / (k - 1), (k^{l+1} - 1) / (k - 1))``
    — contiguous, so a level is a range, not a list.
    """

    num_peers: int
    fanout: int

    def __post_init__(self):
        if self.num_peers < 1:
            raise ValueError(f"num_peers must be >= 1, got {self.num_peers}")
        if self.fanout < 2:
            raise ValueError(
                f"tree fanout must be >= 2, got {self.fanout} "
                "(a 1-ary tree is a chain with O(P) depth)"
            )

    # -- structure -----------------------------------------------------------
    def parent(self, rank: int) -> Optional[int]:
        """Parent rank, or ``None`` for the root."""
        self._check(rank)
        return None if rank == 0 else (rank - 1) // self.fanout

    def children(self, rank: int) -> range:
        """This rank's children (possibly empty, at most ``fanout``)."""
        self._check(rank)
        lo = self.fanout * rank + 1
        return range(min(lo, self.num_peers), min(lo + self.fanout, self.num_peers))

    def child_slot(self, rank: int) -> int:
        """Which of its parent's ``fanout`` slots this (non-root) rank fills."""
        self._check(rank)
        if rank == 0:
            raise ValueError("the root fills no child slot")
        return (rank - 1) % self.fanout

    def level_of(self, rank: int) -> int:
        """Depth of ``rank`` (root = 0)."""
        self._check(rank)
        level = 0
        while rank > 0:
            rank = (rank - 1) // self.fanout
            level += 1
        return level

    @property
    def depth(self) -> int:
        """Number of levels (1 for a single peer)."""
        return self.level_of(self.num_peers - 1) + 1

    def level_bounds(self, level: int) -> Tuple[int, int]:
        """Rank range ``[start, stop)`` of one level (clipped to P)."""
        if not 0 <= level < self.depth:
            raise IndexError(f"level {level} out of range [0, {self.depth})")
        k = self.fanout
        start = (k ** level - 1) // (k - 1)
        stop = (k ** (level + 1) - 1) // (k - 1)
        return min(start, self.num_peers), min(stop, self.num_peers)

    def levels(self) -> List[range]:
        """All levels, root first."""
        return [range(*self.level_bounds(lvl)) for lvl in range(self.depth)]

    def slot_edges(self, level: int) -> List[Tuple[List[int], List[int]]]:
        """The (children, their parents) of ``level``, one pair of lists per
        child slot that has a member: the reference's one-to-one
        ``ppermute`` of each (level, child slot)."""
        start, stop = self.level_bounds(level)
        out = []
        for slot in range(self.fanout):
            kids = [i for i in range(start, stop) if (i - 1) % self.fanout == slot]
            if kids:
                out.append((kids, [(i - 1) // self.fanout for i in kids]))
        return out

    @property
    def num_hubs(self) -> int:
        """Interior nodes — the ranks that aggregate children."""
        return sum(1 for r in range(self.num_peers) if len(self.children(r)))

    def _check(self, rank: int):
        if not 0 <= rank < self.num_peers:
            raise IndexError(f"rank {rank} out of range [0, {self.num_peers})")

    def describe(self) -> str:
        return (
            f"TreePlan(P={self.num_peers}, fanout={self.fanout}, "
            f"depth={self.depth}, hubs={self.num_hubs})"
        )


@register_exchange("tree")
class TreeAggregate(ReduceScatterMean):
    """Hierarchical k-ary tree mean: bounded fan-in, O(log_k P) rounds.

    ``tree`` / ``tree:4`` — the parameter is the tree fanout (default 2).
    Same estimator as ``allgather_mean`` / ``reduce_scatter`` (the peer
    mean, modulo float re-association along tree edges), different traffic
    shape: every peer talks to at most ``fanout + 1`` others per step.

    On the stacked bank, the up-sweep runs level by level from the deepest,
    child slot by child slot: every peer adds what it receives (the child's
    partial rounded through the wire dtype, or +0.0 where it receives
    nothing, as the reference's ``ppermute`` delivers zeros), the root
    divides by ``P``, and the down-sweep replaces each child's buffer with
    its parent's, rounded through the wire dtype. Row ``r`` of the result
    is what peer ``r`` ends with: the root's mean unrounded, the others'
    relayed.

    Host image: :meth:`LocalP2PCluster._tree_exchange_sync` — hubs are
    mailbox registers, each level's aggregations price as one parallel
    serverless wave sized from buffer bytes. Sparse overlays are refused.
    """

    requires_full_graph = True
    sharded = True
    hierarchical = True

    def __init__(self, param: Optional[str] = None):
        self.fanout = 2 if param is None else int(param)
        if self.fanout < 2:
            raise ValueError(f"tree fanout must be >= 2, got {self.fanout}")
        self._plans: Dict[int, TreePlan] = {}

    def tree_plan(self, num_peers: int) -> TreePlan:
        """The (cached) aggregation tree for this peer count."""
        plan = self._plans.get(num_peers)
        if plan is None:
            plan = self._plans[num_peers] = TreePlan(max(int(num_peers), 1), self.fanout)
        return plan

    def _check_full(self, ctx):
        if ctx.mixing is not None:
            raise ValueError(
                "tree aggregation reduces over ALL peers through hub "
                "ranks and the protocol only supports graph='full'; use "
                "allgather_mean (or qsgd/topk) for sparse overlays"
            )

    # -- device path ---------------------------------------------------------
    def combine(self, grads, ctx, *, generator=None, state=None):
        self._check_full(ctx)
        plan, acc = self._bank_buffer(grads, ctx)  # (P, padded) f32, row r = peer r
        P = acc.shape[0]
        if P == 1:
            return plan.unflatten(acc, lead=1), state
        tp = self.tree_plan(P)
        for level in range(tp.depth - 1, 0, -1):
            for kids, parents in tp.slot_edges(level):
                recv = torch.zeros_like(acc)
                recv[parents] = _round_trip(acc[kids], ctx.wire_dtype)
                acc = acc + recv
        acc = acc / P  # the root now holds the global mean; others, partials
        for level in range(tp.depth - 1):
            for kids, parents in tp.slot_edges(level + 1):
                acc[kids] = _round_trip(acc[parents], ctx.wire_dtype)
        return plan.unflatten(acc, lead=1), state

    # -- accounting ----------------------------------------------------------
    def wire_bytes_per_edge(self, grads_like, ctx) -> int:
        """One tree hop carries the whole flattened buffer (a partial sum is
        as dense as the model), not a 1/P shard."""
        plan = self.plan(grads_like, ctx)
        return plan.padded_size * torch.empty((), dtype=ctx.wire_dtype).element_size()

    def wire_bytes(self, grads_like, ctx) -> int:
        """Total tree traffic per step: P-1 up messages + P-1 down relays."""
        P_ = max(int(ctx.num_peers), 1)
        return 2 * (P_ - 1) * self.wire_bytes_per_edge(grads_like, ctx)

    def host_wire_bytes(self, grads_like, ctx) -> int:
        """Mailbox publishes per peer per step: at most one partial up plus
        one down relay."""
        return 2 * self.wire_bytes_per_edge(grads_like, ctx)
