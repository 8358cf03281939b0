"""Peer overlay graphs — the communication topology as a first-class API.

A numpy copy of the reference's ``repro/core/graph.py``; the port keeps its
own so that it imports nothing of the JAX package.

Every layer of the seed repro hard-coded a fully-connected overlay: the
exchange protocols averaged over *all* peers, :class:`HostMailbox`
broadcast to all P queues, and the cost model charged ``(P-1) x payload``
per step. The paper's central scalability concern is exactly that
communication overhead as P grows; SPIRT (arXiv:2309.14148) and the
fault-tolerance architecture study (arXiv:2302.13995) both motivate
sparser, churn-tolerant peer graphs. This module makes the overlay a
registry-backed abstraction, mirroring ``exchange.py``:

* :class:`PeerGraph` — neighbor sets, a Metropolis–Hastings mixing matrix
  ``W``, and diagnostics (degrees, spectral gap).
* ``@register_graph`` / :func:`get_graph` — name-based resolution with
  parameterized specs: ``"full"``, ``"ring"``, ``"gossip:k"`` (seeded
  random ≥k-regular on a ring backbone), ``"hierarchical[:group]"``
  (hub-and-spoke groups, hubs fully connected), ``"static"`` (explicit
  adjacency, programmatic only).

``Topology(graph="ring")`` resolves through this registry; sync exchange
protocols generalize from the global mean to neighbor-weighted mixing
``x_r <- sum_j W[r, j] x_j``.

Why Metropolis–Hastings: with ``W_ij = 1 / (1 + max(d_i, d_j))`` on edges
and ``W_ii = 1 - sum_j W_ij``, the matrix is symmetric and doubly
stochastic for ANY undirected graph, so decentralized SGD preserves the
gradient average in expectation and converges at a rate governed by the
spectral gap ``1 - |lambda_2(W)|``. On the complete graph every degree is
``P - 1``, so ``W_ij = 1/P`` everywhere — the neighbor-weighted mix
*provably reduces* to today's ``allgather_mean`` arithmetic; the exchange
layer exploits this by keeping the legacy (bit-exact) mean path whenever
the resolved graph is ``full``.

Storage contract (10k–100k peers): graphs are CSR neighbor lists
(``indptr`` / ``indices``), built vectorized — O(E) memory, never O(P²).
The dense surfaces (``adjacency``, ``mixing_matrix()``) are *lazy* and
gated behind ``DENSE_MATERIALIZE_LIMIT``: below the limit they
materialize (and the sparse per-row accessors are property-tested against
them); above it they raise with a pointer to the O(degree) accessors —
``neighbors_array(r)``, ``mixing_row(r)``, ``mixing_weights(r)``,
``has_edge(i, j)``. The spectral gap switches from the O(P³)
``eigvalsh`` oracle to power iteration on the sparse mixing operator.
``FullGraph`` stores nothing at all (the complete graph is implicit), so
even P=100k "full" overlays cost O(1) memory.
"""
from __future__ import annotations

import abc
from typing import ClassVar, Dict, Optional, Sequence, Tuple, Type

import numpy as np

# Largest peer count for which the dense (P, P) surfaces — ``adjacency``
# and ``mixing_matrix()`` — may materialize. 4096² bools = 16 MB /
# float64s = 128 MB: fine for tests and small fleets, a hard refusal
# beyond (a 100k-peer dense mixing matrix would be 80 GB).
DENSE_MATERIALIZE_LIMIT = 4096


def _csr_from_edges(num_peers: int, edges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unique undirected edges ``(E, 2)`` -> sorted CSR (indptr, indices)."""
    P = int(num_peers)
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    if edges.size:
        a = np.minimum(edges[:, 0], edges[:, 1])
        b = np.maximum(edges[:, 0], edges[:, 1])
        keep = a != b  # no self-loops
        a, b = a[keep], b[keep]
        key = np.unique(a * P + b)  # dedupe + deterministic order
        a, b = key // P, key % P
        both = np.concatenate([np.stack([a, b], 1), np.stack([b, a], 1)])
        order = np.lexsort((both[:, 1], both[:, 0]))
        both = both[order]
        indices = np.ascontiguousarray(both[:, 1])
        counts = np.bincount(both[:, 0], minlength=P)
    else:
        indices = np.zeros(0, np.int64)
        counts = np.zeros(P, np.int64)
    indptr = np.zeros(P + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, indices


def _gather_rows(
    indptr: np.ndarray, indices: np.ndarray, rows: np.ndarray
) -> np.ndarray:
    """Concatenated CSR rows ``indices[indptr[r]:indptr[r+1]] for r in rows``
    without a Python loop (the classic multi-range gather trick)."""
    starts = indptr[rows]
    counts = indptr[rows + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    # src[t] = starts[r] + (t - cumstart[r]) for the row r owning slot t
    cumstart = np.concatenate([[0], np.cumsum(counts)[:-1]])
    src = np.repeat(starts - cumstart, counts) + np.arange(total, dtype=np.int64)
    return indices[src]


class PeerGraph(abc.ABC):
    """An undirected overlay over ``num_peers`` ranks.

    Rank ``r`` is the peer's mesh-axis index on the device path and the
    ``PeerState.rank`` on the host path, so one graph object describes
    both. Subclasses implement :meth:`build_neighbors` (CSR, preferred —
    O(E)) or legacy :meth:`build_adjacency` (dense, auto-converted);
    everything else (neighbor queries, mixing weights, diagnostics)
    derives from the CSR storage.
    """

    name: ClassVar[str] = "?"  # set by @register_graph
    # Implicit graphs (the complete graph) answer every query analytically
    # and skip CSR storage entirely — O(1) memory at any P.
    implicit: ClassVar[bool] = False

    def __init__(self, num_peers: int):
        if num_peers < 1:
            raise ValueError(f"num_peers must be >= 1, got {num_peers}")
        self.num_peers = int(num_peers)
        self._dense: Optional[np.ndarray] = None  # lazy (P, P) bool
        self._degrees: Optional[np.ndarray] = None
        # lazy Metropolis–Hastings CSR-aligned edge weights + self weights
        self._mix_rows_cache: Optional[np.ndarray] = None  # row of each nz
        self._mix_w: Optional[np.ndarray] = None
        self._mix_self: Optional[np.ndarray] = None
        if not self.implicit:
            self._indptr, self._indices = self._validated_csr()

    # -- construction --------------------------------------------------------
    def build_neighbors(self) -> Tuple[np.ndarray, np.ndarray]:
        """CSR ``(indptr, indices)`` — override this for O(E) construction.

        The default converts a legacy dense :meth:`build_adjacency`, so
        existing subclasses keep working unchanged (at dense cost).
        """
        adj = np.asarray(self.build_adjacency(), dtype=bool)
        P = self.num_peers
        if adj.shape != (P, P):
            raise ValueError(
                f"{type(self).__name__} built adjacency {adj.shape}, "
                f"expected {(P, P)}"
            )
        if not np.array_equal(adj, adj.T):
            raise ValueError(f"{type(self).__name__} adjacency must be symmetric")
        adj = adj.copy()
        np.fill_diagonal(adj, False)  # no self-loops; W_ii comes from MH
        rows, cols = np.nonzero(adj)
        indptr = np.zeros(P + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=P), out=indptr[1:])
        return indptr, cols.astype(np.int64)

    def build_adjacency(self) -> np.ndarray:
        """(P, P) symmetric bool adjacency; the diagonal is ignored.
        Legacy hook — implement :meth:`build_neighbors` for large P."""
        raise NotImplementedError(
            f"{type(self).__name__} must implement build_neighbors() "
            "(CSR, scalable) or build_adjacency() (dense, legacy)"
        )

    def _validated_csr(self) -> Tuple[np.ndarray, np.ndarray]:
        indptr, indices = self.build_neighbors()
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int64)
        P = self.num_peers
        if indptr.shape != (P + 1,) or indptr[0] != 0 or indptr[-1] != indices.size:
            raise ValueError(
                f"{type(self).__name__} built a malformed CSR indptr "
                f"(shape {indptr.shape}, last={indptr[-1] if indptr.size else '-'}, "
                f"nnz={indices.size})"
            )
        if indices.size:
            if indices.min() < 0 or indices.max() >= P:
                raise ValueError(
                    f"{type(self).__name__} CSR indices out of range [0, {P})"
                )
            rows = np.repeat(np.arange(P, dtype=np.int64), np.diff(indptr))
            if np.any(rows == indices):
                raise ValueError(
                    f"{type(self).__name__} adjacency has self-loops; a peer "
                    "is not its own neighbor"
                )
            # symmetry: the directed edge multiset must equal its reverse
            fwd = np.sort(rows * P + indices)
            rev = np.sort(indices * P + rows)
            if not np.array_equal(fwd, rev):
                raise ValueError(
                    f"{type(self).__name__} adjacency must be symmetric"
                )
            if fwd.size != np.unique(fwd).size:
                raise ValueError(
                    f"{type(self).__name__} CSR contains duplicate edges"
                )
        indptr.setflags(write=False)
        indices.setflags(write=False)
        return indptr, indices

    # -- neighbor sets -------------------------------------------------------
    @property
    def adjacency(self) -> np.ndarray:
        """Dense (P, P) bool view — lazy, and refused above
        ``DENSE_MATERIALIZE_LIMIT`` (use :meth:`neighbors_array` /
        :meth:`has_edge` at scale)."""
        if self._dense is None:
            self._check_dense_ok("adjacency")
            P = self.num_peers
            dense = np.zeros((P, P), dtype=bool)
            if self._indices.size:
                rows = np.repeat(np.arange(P), np.diff(self._indptr))
                dense[rows, self._indices] = True
            dense.setflags(write=False)
            self._dense = dense
        return self._dense

    def _check_dense_ok(self, what: str) -> None:
        if self.num_peers > DENSE_MATERIALIZE_LIMIT:
            raise ValueError(
                f"refusing to materialize dense {what} for P="
                f"{self.num_peers} (> DENSE_MATERIALIZE_LIMIT="
                f"{DENSE_MATERIALIZE_LIMIT}): that is O(P^2) memory. Use the "
                "sparse surface instead — neighbors_array(r), mixing_row(r), "
                "mixing_weights(r), has_edge(i, j), spectral_gap()."
            )

    def neighbors_array(self, rank: int) -> np.ndarray:
        """Ranks adjacent to ``rank`` as an int64 array (ascending) —
        an O(1) CSR slice, the scalable form of :meth:`neighbors`."""
        return self._indices[self._indptr[rank]:self._indptr[rank + 1]]

    def neighbors(self, rank: int) -> Tuple[int, ...]:
        """Ranks adjacent to ``rank`` (self excluded), ascending."""
        return tuple(int(j) for j in self.neighbors_array(rank))

    def has_edge(self, i: int, j: int) -> bool:
        """O(log degree) undirected edge test (False for i == j)."""
        row = self.neighbors_array(i)
        pos = np.searchsorted(row, j)
        return bool(pos < row.size and row[pos] == j)

    @property
    def is_full(self) -> bool:
        """True iff every pair of distinct peers is connected."""
        P = self.num_peers
        return self.num_edges * 2 == P * (P - 1)

    def is_connected(self) -> bool:
        """Vectorized frontier BFS on the CSR rows."""
        P = self.num_peers
        if P <= 1:
            return True
        seen = np.zeros(P, dtype=bool)
        seen[0] = True
        frontier = np.array([0], dtype=np.int64)
        n_seen = 1
        while frontier.size:
            nxt = np.unique(_gather_rows(self._indptr, self._indices, frontier))
            nxt = nxt[~seen[nxt]]
            if nxt.size == 0:
                break
            seen[nxt] = True
            n_seen += int(nxt.size)
            frontier = nxt
        return n_seen == P

    # -- mixing --------------------------------------------------------------
    def _ensure_mix(self) -> None:
        """CSR-aligned MH edge weights + per-row self weights (lazy)."""
        if self._mix_w is not None:
            return
        d = self.degrees
        P = self.num_peers
        rows = np.repeat(np.arange(P, dtype=np.int64), np.diff(self._indptr))
        w = 1.0 / (1.0 + np.maximum(d[rows], d[self._indices]).astype(np.float64))
        w_self = 1.0 - np.bincount(rows, weights=w, minlength=P)
        self._mix_rows_cache = rows
        self._mix_w = w
        self._mix_self = w_self

    def mixing_weights(self, rank: int) -> Tuple[np.ndarray, np.ndarray, float]:
        """O(degree) Metropolis–Hastings row: ``(neighbor_ranks, weights,
        self_weight)`` — the sparse form of :meth:`mixing_row`."""
        self._ensure_mix()
        lo, hi = self._indptr[rank], self._indptr[rank + 1]
        return self._indices[lo:hi], self._mix_w[lo:hi], float(self._mix_self[rank])

    def mixing_row(self, rank: int) -> np.ndarray:
        """Dense float64 row ``W[rank]`` assembled from the sparse weights
        — identical to ``mixing_matrix()[rank]`` (the equivalence every
        registered graph is contract-checked for) without ever building
        the (P, P) matrix."""
        P = self.num_peers
        d = self.degrees
        row = np.zeros(P, dtype=np.float64)
        nbrs = self.neighbors_array(rank)
        if nbrs.size:
            row[nbrs] = 1.0 / (
                1.0 + np.maximum(d[rank], d[nbrs]).astype(np.float64)
            )
        row[rank] = 1.0 - row.sum()
        return row

    def mixing_matrix(self) -> np.ndarray:
        """Metropolis–Hastings weights: symmetric, doubly stochastic fp64.

        ``W_ij = 1 / (1 + max(d_i, d_j))`` on edges, ``W_ii`` absorbs the
        remainder. Degrees exclude self, so an isolated peer gets
        ``W_ii = 1`` (it keeps its own gradient). Dense — refused above
        ``DENSE_MATERIALIZE_LIMIT``; use :meth:`mixing_row` /
        :meth:`mixing_weights` at scale.
        """
        self._check_dense_ok("mixing_matrix")
        P = self.num_peers
        d = self.degrees
        W = np.zeros((P, P), dtype=np.float64)
        if self._indices.size:
            rows = np.repeat(np.arange(P, dtype=np.int64), np.diff(self._indptr))
            W[rows, self._indices] = 1.0 / (
                1.0 + np.maximum(d[rows], d[self._indices]).astype(np.float64)
            )
        W[np.arange(P), np.arange(P)] = 1.0 - W.sum(axis=1)
        return W

    def mix_apply(self, x: np.ndarray) -> np.ndarray:
        """``W @ x`` through the sparse operator — O(E), never O(P²).
        ``x`` may be (P,) or (P, k)."""
        self._ensure_mix()
        x = np.asarray(x, np.float64)
        contrib = self._mix_w[:, None] * x[self._indices] if x.ndim == 2 else (
            self._mix_w * x[self._indices]
        )
        if x.ndim == 2:
            y = self._mix_self[:, None] * x
            np.add.at(y, self._mix_rows_cache, contrib)
        else:
            y = self._mix_self * x + np.bincount(
                self._mix_rows_cache, weights=contrib, minlength=self.num_peers
            )
        return y

    # -- diagnostics ---------------------------------------------------------
    @property
    def degrees(self) -> np.ndarray:
        if self._degrees is None:
            d = np.diff(self._indptr).astype(np.int64)
            d.setflags(write=False)
            self._degrees = d
        return self._degrees

    def degree(self, rank: int) -> int:
        """O(1) neighbor count of one rank."""
        return int(self._indptr[rank + 1] - self._indptr[rank])

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max())

    @property
    def mean_degree(self) -> float:
        return float(self.degrees.mean())

    @property
    def num_edges(self) -> int:
        """Undirected edge count."""
        return int(self._indptr[-1]) // 2

    def spectral_gap(
        self,
        method: str = "auto",
        *,
        max_iter: int = 500,
        tol: float = 1e-12,
    ) -> float:
        """``1 - |lambda_2|`` of the mixing matrix — the decentralized-SGD
        consensus rate. 1.0 for the complete graph (one-shot consensus),
        0.0 for a disconnected graph (no consensus across components).

        ``method="dense"`` is the O(P³) ``eigvalsh`` oracle (refused above
        the dense limit); ``method="power"`` runs power iteration on the
        sparse operator with the uniform top eigenvector deflated (W is
        doubly stochastic, so its dominant eigenpair is ``(1, 1/sqrt(P))``
        exactly); ``"auto"`` picks the oracle for small P.
        """
        if self.num_peers == 1:
            return 1.0
        if method not in ("auto", "dense", "power"):
            raise ValueError(
                f"spectral_gap method must be 'auto', 'dense' or 'power', "
                f"got {method!r}"
            )
        if method == "auto":
            method = "dense" if self.num_peers <= 512 else "power"
        if method == "dense":
            lam = np.linalg.eigvalsh(self.mixing_matrix())
            mags = np.sort(np.abs(lam))[::-1]
            return float(1.0 - mags[1])
        P = self.num_peers
        # deterministic seeded start vector, orthogonal to the uniform
        # dominant eigenvector (re-projected every iteration against drift)
        x = np.random.default_rng(0).standard_normal(P)
        x -= x.mean()
        nx = np.linalg.norm(x)
        if nx == 0.0:
            return 1.0
        x /= nx
        lam2, prev = 0.0, np.inf
        for _ in range(max_iter):
            y = self.mix_apply(x)
            y -= y.mean()
            ny = np.linalg.norm(y)
            if ny <= 1e-300:
                lam2 = 0.0  # W annihilates the complement (complete graph)
                break
            lam2 = ny  # ||W x|| with ||x|| = 1 -> |lambda| estimate
            x = y / ny
            if abs(lam2 - prev) <= tol * max(lam2, 1e-30):
                break
            prev = lam2
        return float(1.0 - min(lam2, 1.0))

    def describe(self) -> str:
        return (
            f"{self.name}(P={self.num_peers}, degree"
            f"={self.mean_degree:g} mean/{self.max_degree} max, "
            f"edges={self.num_edges}, spectral_gap={self.spectral_gap():.3f})"
        )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type[PeerGraph]] = {}


def register_graph(name: str):
    """Class decorator: make a graph reachable as ``Topology(graph=name)``."""

    def deco(cls: Type[PeerGraph]) -> Type[PeerGraph]:
        if not issubclass(cls, PeerGraph):
            raise TypeError(f"{cls!r} must subclass PeerGraph")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def available_graphs() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_graph(spec, num_peers: int, *, seed: int = 0) -> PeerGraph:
    """Resolve a graph spec for ``num_peers`` ranks.

    ``spec`` is a :class:`PeerGraph` instance (validated for size and
    passed through), or a registered name with an optional integer
    parameter suffix: ``"full"``, ``"ring"``, ``"gossip:3"``,
    ``"hierarchical:4"``. ``seed`` feeds stochastic constructions
    (``gossip``) so the overlay is reproducible.
    """
    if isinstance(spec, PeerGraph):
        if spec.num_peers != num_peers:
            raise ValueError(
                f"graph was built for {spec.num_peers} peers, "
                f"topology has {num_peers}"
            )
        return spec
    name, _, arg = str(spec).partition(":")
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown peer graph {spec!r}; registered graphs: "
            f"{', '.join(available_graphs())}"
        ) from None
    kwargs = {}
    if arg:
        try:
            kwargs["param"] = int(arg)
        except ValueError:
            raise ValueError(
                f"graph spec {spec!r}: parameter after ':' must be an int"
            ) from None
    try:
        return cls(num_peers, seed=seed, **kwargs)
    except TypeError:
        # mirror get_exchange: an un-parameterized graph given a ':' arg is
        # a clean spec error, not a constructor-signature leak
        if kwargs:
            raise ValueError(
                f"peer graph {name!r} does not take a ':' parameter "
                f"(got {spec!r})"
            ) from None
        raise


# ---------------------------------------------------------------------------
# Registered graphs
# ---------------------------------------------------------------------------


@register_graph("full")
class FullGraph(PeerGraph):
    """Complete graph — the seed repo's implicit overlay. MH mixing is the
    uniform ``1/P`` matrix, i.e. exactly the global mean. Stored
    implicitly: every query is answered analytically in O(1)/O(P), so a
    100k-peer full overlay costs no edge memory at all."""

    implicit = True

    def __init__(self, num_peers: int, *, seed: int = 0):
        super().__init__(num_peers)

    def build_adjacency(self) -> np.ndarray:
        return ~np.eye(self.num_peers, dtype=bool)

    # -- implicit sparse surface --------------------------------------------
    @property
    def adjacency(self) -> np.ndarray:
        if self._dense is None:
            self._check_dense_ok("adjacency")
            dense = ~np.eye(self.num_peers, dtype=bool)
            dense.setflags(write=False)
            self._dense = dense
        return self._dense

    def neighbors_array(self, rank: int) -> np.ndarray:
        out = np.arange(self.num_peers, dtype=np.int64)
        return np.delete(out, rank)

    def has_edge(self, i: int, j: int) -> bool:
        P = self.num_peers
        return bool(i != j and 0 <= i < P and 0 <= j < P)

    @property
    def is_full(self) -> bool:
        return True

    def is_connected(self) -> bool:
        return True

    @property
    def degrees(self) -> np.ndarray:
        if self._degrees is None:
            d = np.full(self.num_peers, self.num_peers - 1, np.int64)
            d.setflags(write=False)
            self._degrees = d
        return self._degrees

    def degree(self, rank: int) -> int:
        return self.num_peers - 1

    @property
    def num_edges(self) -> int:
        P = self.num_peers
        return P * (P - 1) // 2

    def mixing_weights(self, rank: int) -> Tuple[np.ndarray, np.ndarray, float]:
        P = self.num_peers
        nbrs = self.neighbors_array(rank)
        return nbrs, np.full(nbrs.size, 1.0 / P, np.float64), 1.0 / P

    def mixing_row(self, rank: int) -> np.ndarray:
        return np.full(self.num_peers, 1.0 / self.num_peers, np.float64)

    def mixing_matrix(self) -> np.ndarray:
        self._check_dense_ok("mixing_matrix")
        P = self.num_peers
        return np.full((P, P), 1.0 / P, np.float64)

    def mix_apply(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        return np.broadcast_to(x.mean(axis=0), x.shape).copy()

    def spectral_gap(self, method: str = "auto", **kw) -> float:
        # W = uniform 1/P: eigenvalues are {1, 0, ..., 0} exactly.
        return 1.0


@register_graph("ring")
class RingGraph(PeerGraph):
    """Bidirectional ring: ``r`` talks to ``(r ± 1) mod P``. Per-peer wire
    bytes are O(1) in P — the canonical sparse decentralized-SGD overlay."""

    def __init__(self, num_peers: int, *, seed: int = 0):
        super().__init__(num_peers)

    def build_neighbors(self) -> Tuple[np.ndarray, np.ndarray]:
        P = self.num_peers
        r = np.arange(P, dtype=np.int64)
        edges = np.stack([r, (r + 1) % P], axis=1)  # P==1,2 dedupe in CSR
        return _csr_from_edges(P, edges)


def _ring_edges(P: int) -> np.ndarray:
    r = np.arange(P, dtype=np.int64)
    return np.stack([r, (r + 1) % P], axis=1)


@register_graph("gossip")
class GossipGraph(PeerGraph):
    """Seeded random ≥k-regular gossip overlay on a ring backbone.

    A ring guarantees connectivity; extra edges are then sampled in seeded
    vectorized rounds (each round proposes one uniform partner per
    still-deficient peer) until every peer has degree at least ``k``.
    ``"gossip:3"`` selects k=3; per-peer wire bytes are O(k), independent
    of P. ``k`` must satisfy ``k < P`` — a simple graph cannot give a
    peer more than P-1 distinct neighbors.
    """

    def __init__(self, num_peers: int, *, seed: int = 0, param: Optional[int] = None):
        self.k = int(param) if param is not None else 3
        if self.k < 1:
            raise ValueError(f"gossip degree k must be >= 1, got {self.k}")
        if self.k >= num_peers > 1:
            raise ValueError(
                f"gossip degree k={self.k} is unsatisfiable for "
                f"num_peers={num_peers}: a simple graph gives each peer at "
                f"most P-1={num_peers - 1} neighbors; pick k <= "
                f"{max(num_peers - 1, 1)} or grow the fleet"
            )
        self.seed = seed
        super().__init__(num_peers)

    def build_neighbors(self) -> Tuple[np.ndarray, np.ndarray]:
        P, k = self.num_peers, self.k
        ring = _ring_edges(P)
        if k <= 2 or P <= 3:
            return _csr_from_edges(P, ring)
        rng = np.random.default_rng(self.seed)
        a = np.minimum(ring[:, 0], ring[:, 1])
        b = np.maximum(ring[:, 0], ring[:, 1])
        keys = np.unique(a * P + b)  # existing undirected edge keys
        deg = np.bincount(
            np.concatenate([keys // P, keys % P]), minlength=P
        ).astype(np.int64)
        # seeded vectorized rounds: shuffle the still-deficient peers and
        # pair them up, so every accepted edge lifts TWO deficient degrees
        # and the overlay stays near-regular; an odd straggler proposes a
        # uniform partner. Duplicates and existing edges are dropped, so a
        # round is O(deficient log E) — a handful of rounds reach k
        for _ in range(4 * k + 32):
            deficient = np.flatnonzero(deg < k)
            if deficient.size == 0:
                break
            order = rng.permutation(deficient)
            half = order.size // 2
            src, dst = order[:half], order[half:2 * half]
            if order.size % 2:
                odd = order[-1:]
                partner = rng.integers(0, P - 1, size=1)
                partner += partner >= odd  # uniform over P-1 non-self ranks
                src = np.concatenate([src, odd])
                dst = np.concatenate([dst, partner])
            lo = np.minimum(src, dst)
            hi = np.maximum(src, dst)
            keep = lo != hi
            prop = np.unique(lo[keep] * P + hi[keep])
            new = prop[~np.isin(prop, keys)]
            if new.size == 0:
                continue
            keys = np.concatenate([keys, new])
            deg += np.bincount(
                np.concatenate([new // P, new % P]), minlength=P
            )
        else:
            # deterministic circulant fallback for pathological draws
            for off in range(2, P // 2 + 1):
                deficient = np.flatnonzero(deg < k)
                if deficient.size == 0:
                    break
                j = (deficient + off) % P
                lo, hi = np.minimum(deficient, j), np.maximum(deficient, j)
                prop = np.unique(lo * P + hi)
                new = prop[~np.isin(prop, keys)]
                if new.size == 0:
                    continue
                keys = np.concatenate([keys, new])
                deg += np.bincount(
                    np.concatenate([new // P, new % P]), minlength=P
                )
        edges = np.stack([keys // P, keys % P], axis=1)
        return _csr_from_edges(P, edges)


@register_graph("hierarchical")
class HierarchicalGraph(PeerGraph):
    """Hub-and-spoke groups: peers split into consecutive groups of
    ``group`` ranks, each group's first rank is its hub; spokes connect
    only to their hub, hubs form a complete graph among themselves.
    ``"hierarchical:4"`` selects group size 4 (default: ~sqrt(P)) — the
    SPIRT-style two-level aggregation overlay."""

    def __init__(self, num_peers: int, *, seed: int = 0, param: Optional[int] = None):
        if param is not None and param < 1:
            raise ValueError(f"hierarchical group size must be >= 1, got {param}")
        self.group = int(param) if param is not None else max(
            1, int(round(np.sqrt(num_peers)))
        )
        super().__init__(num_peers)

    def build_neighbors(self) -> Tuple[np.ndarray, np.ndarray]:
        P, group = self.num_peers, self.group
        r = np.arange(P, dtype=np.int64)
        hub_of = (r // group) * group
        spokes = r[r != hub_of]
        spoke_edges = np.stack([hub_of[spokes], spokes], axis=1)
        hubs = np.arange(0, P, group, dtype=np.int64)
        ih, jh = np.triu_indices(hubs.size, k=1)
        hub_edges = np.stack([hubs[ih], hubs[jh]], axis=1)
        return _csr_from_edges(P, np.concatenate([spoke_edges, hub_edges]))


@register_graph("static")
class StaticGraph(PeerGraph):
    """Explicit adjacency — programmatic only (``Topology(graph=StaticGraph
    .from_edges(P, [...]))``); resolving the bare name raises because there
    is no adjacency to build from."""

    def __init__(self, num_peers: int, adjacency=None, *, seed: int = 0):
        if adjacency is None:
            raise ValueError(
                "static graph needs an explicit adjacency: construct "
                "StaticGraph(P, adjacency) or StaticGraph.from_edges(P, edges) "
                "and pass the instance, not the name"
            )
        self._static_adj = np.asarray(adjacency, dtype=bool)
        super().__init__(num_peers)

    @classmethod
    def from_edges(cls, num_peers: int, edges: Sequence[Tuple[int, int]]):
        adj = np.zeros((num_peers, num_peers), dtype=bool)
        for i, j in edges:
            adj[i, j] = adj[j, i] = True
        return cls(num_peers, adj)

    def build_adjacency(self) -> np.ndarray:
        return self._static_adj
