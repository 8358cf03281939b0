"""Registry contract cross-validation over the port's registries: the
port's copy of the reference's ``repro/analysis/contracts.py``.

The exchange, graph and allocation registries promise behaviour through
declarative ``ClassVar`` flags (``core/exchange.py``: ``name``,
``is_async``, ``requires_key``, ``decomposes_per_edge``,
``requires_full_graph``, ``sharded``, ``lossy``, ``hierarchical``).
Nothing in Python makes a flag true, so this pass instantiates every
registered implementation and *executes* each flag's observable
consequence against its declaration, with the reference's rules:

* ``RC001`` name integrity: ``cls.name`` matches its registry key, no
  ``":"`` inside a name (the spec parameter separator).
* ``RC002`` ``requires_key`` <=> ``host_encode(generator=None)`` raises.
* ``RC003`` ``lossy`` <=> ``combine_ef`` is overridden.
* ``RC004`` ``lossy`` <=> the host wire roundtrip of a seeded gradient
  dict is not exact; wire bytes are positive.
* ``RC005`` ``is_async`` <=> carried state: ``init_state`` non-None and
  ``combine(state=None)`` refused.
* ``RC006`` ``exchange_context`` on a ring of 6 peers raises iff
  ``requires_full_graph or not decomposes_per_edge``.
* ``RC007`` wire accounting: ``wire_bytes == round(per_edge * degree)``
  for decomposing protocols; fused and sharded ones override
  ``wire_bytes``, sharded ones ``host_wire_bytes``.
* ``RC008`` ``sharded`` <=> the shard surface (``plan``,
  ``host_encode_shard``, ``host_decode_shard``), one shard per peer, and
  a shard's roundtrip keeps its values.
* ``RC009`` spec parsing: parameterized names accept their sample spec,
  every other name rejects ``name:1`` (graphs ``name:2``) with a clean
  ``ValueError``; ``static`` refuses construction by name.
* ``RC010`` every overlay at P = 8 is symmetric, loop-free and connected,
  with a doubly stochastic Metropolis–Hastings matrix.
* ``RC011`` every allocation policy returns the planner's ``planned_mb``
  with no history.
* ``RC012`` (info) a name registered in more than one registry.
* ``RC013`` the sparse graph surface agrees with the dense oracles.

The samples are seeded numpy arrays turned into tensors on the CPU. Each
finding names the class by its source file and line. The registries may
hold entries that are not the port's own (a test registers throwaway
protocols): the pass checks whatever is registered, and an entry that
raises where a rule expects none is a finding of that rule, not a crash.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.common import Finding
from repro_torch.core import events, exchange, graph
from repro_torch.core.exchange import ExchangeContext, ExchangeProtocol, get_exchange
from repro_torch.core.p2p import Topology, exchange_context

PASS_NAME = "contracts"

CONTRACT_RULES = tuple(f"RC{i:03d}" for i in range(1, 14))

# Parameterized names and a known-good sample argument; every other
# registered name must REJECT a ':' parameter.
PARAM_EXCHANGE_SAMPLES: Dict[str, str] = {"trimmed_mean": "0.25", "krum": "2"}
PARAM_GRAPH_SAMPLES: Dict[str, str] = {"gossip": "3", "hierarchical": "4"}

_P = 6  # peer count of the contract contexts


def _where(cls: type) -> Tuple[str, int]:
    try:
        path = inspect.getsourcefile(cls) or "<registry>"
        line = inspect.getsourcelines(cls)[1]
    except (OSError, TypeError):
        path, line = "<registry>", 1
    return path, line


class _Checker:
    def __init__(self) -> None:
        self.findings: List[Finding] = []
        self.checks_run = 0
        self.rule = "RC001"  # the rule being checked, for an entry that raises

    def expect(self, ok: bool, rule: str, cls: type, message: str, *,
               severity: str = "error") -> None:
        self.checks_run += 1
        if not ok:
            path, line = _where(cls)
            self.findings.append(Finding(
                rule=rule, severity=severity, path=path, line=line,
                message=f"{cls.__name__}: {message}", pass_name=PASS_NAME,
            ))

    def raises(self, fn: Callable[[], Any], exc: type = ValueError) -> Optional[bool]:
        """True if fn raised exc, False if it returned, None on another
        exception (reported by the caller as its own violation)."""
        try:
            fn()
        except exc:
            return True
        except Exception:
            return None
        return False

    def guarded(self, cls: type, fn: Callable[[], None]) -> None:
        """Run one entry's checks; an exception escaping them is a finding
        of the rule that was being checked."""
        try:
            fn()
        except Exception as e:  # an entry of any origin must not stop the pass
            self.expect(False, self.rule, cls,
                        f"raised {type(e).__name__} while {self.rule} was checked: {e}")


def _sample_tree(seed: int = 0) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal((16,)).astype(np.float32)),
    }


def _trees_equal(a, b) -> bool:
    return set(a) == set(b) and all(
        torch.equal(a[k].to(torch.float32), b[k].to(torch.float32)) for k in a)


def _check_exchange(ck: _Checker) -> None:
    ctx = ExchangeContext(num_peers=_P)
    tree = _sample_tree()
    bank = {k: v.expand(_P, *v.shape).clone() for k, v in tree.items()}
    for name in exchange.available_exchanges():
        ck.rule = "RC009"
        spec = f"{name}:{PARAM_EXCHANGE_SAMPLES[name]}" if name in PARAM_EXCHANGE_SAMPLES else name
        ck.guarded(exchange._REGISTRY[name],
                   lambda: _check_protocol(ck, name, spec, get_exchange(spec), ctx, tree, bank))


def _check_protocol(ck: _Checker, name: str, spec: str, proto, ctx, tree, bank) -> None:
    cls = type(proto)
    gen = lambda: torch.Generator().manual_seed(0)

    ck.rule = "RC001"  # name integrity
    ck.expect(proto.name == name, "RC001", cls,
              f"registered as {name!r} but cls.name is {proto.name!r}")
    ck.expect(":" not in name, "RC001", cls,
              f"name {name!r} contains ':', the spec parameter separator")

    ck.rule = "RC002"  # requires_key <=> keyless host_encode refused
    keyless = ck.raises(lambda: proto.host_encode(tree, ctx, generator=None))
    if proto.requires_key:
        ck.expect(keyless is True, "RC002", cls,
                  "declares requires_key=True but host_encode(generator=None) did not raise "
                  "ValueError")
    else:
        ck.expect(keyless is False, "RC002", cls,
                  "declares requires_key=False but host_encode(generator=None) failed: either "
                  "it needs a generator (set requires_key=True) or the keyless encode path "
                  "is broken")

    ck.rule = "RC003"  # lossy <=> combine_ef override
    overridden = cls.combine_ef is not ExchangeProtocol.combine_ef
    ck.expect(overridden == proto.lossy, "RC003", cls,
              f"lossy={proto.lossy} but combine_ef is "
              f"{'overridden' if overridden else 'the zero-residual default'}: error feedback "
              "only applies to (and must cover all) lossy codecs")

    ck.rule = "RC004"  # lossy <=> the wire roundtrip drops information (dense wire only)
    if not proto.sharded:
        payload, nbytes = proto.host_encode(
            tree, ctx, generator=gen() if proto.requires_key else None)
        exact = _trees_equal(proto.host_decode(payload, tree, ctx), tree)
        ck.expect(exact != proto.lossy, "RC004", cls,
                  f"lossy={proto.lossy} but the host encode/decode roundtrip "
                  f"{'was exact' if exact else 'changed the gradient'}")
        ck.expect(isinstance(nbytes, int) and nbytes > 0, "RC004", cls,
                  f"host_encode reported non-positive wire bytes ({nbytes!r})")

    ck.rule = "RC005"  # is_async <=> carried mailbox state
    state = proto.init_state(tree, ctx)
    if proto.is_async:
        ck.expect(state is not None, "RC005", cls,
                  "declares is_async=True but init_state returned None: an async protocol "
                  "must carry mailbox state")
        stateless = ck.raises(lambda: proto.combine(bank, ctx, state=None))
        ck.expect(stateless is True, "RC005", cls,
                  "declares is_async=True but combine(state=None) did not refuse with "
                  "ValueError")
    else:
        ck.expect(state is None, "RC005", cls,
                  "declares is_async=False but init_state returned carried state")

    ck.rule = "RC006"  # sparse-overlay refusal path matches the flags
    must_refuse = proto.requires_full_graph or not proto.decomposes_per_edge
    refused = ck.raises(lambda: exchange_context(Topology(exchange=spec, graph="ring"),
                                                 num_peers=_P))
    ck.expect(refused is must_refuse, "RC006", cls,
              f"requires_full_graph={proto.requires_full_graph}, "
              f"decomposes_per_edge={proto.decomposes_per_edge} but a ring overlay was "
              f"{'accepted' if refused is False else 'refused' if refused else 'broken'}: "
              "the flags and the refusal path disagree")

    ck.rule = "RC007"  # wire accounting matches the decomposition flag
    if proto.decomposes_per_edge and not proto.sharded:
        per_edge = proto.wire_bytes_per_edge(tree, ctx)
        total = proto.wire_bytes(tree, ctx)
        ck.expect(total == int(round(per_edge * ctx.degree)), "RC007", cls,
                  f"decomposes_per_edge=True but wire_bytes ({total}) != per_edge "
                  f"({per_edge}) x degree ({ctx.degree})")
    if not proto.decomposes_per_edge or proto.sharded:
        ck.expect(cls.wire_bytes is not ExchangeProtocol.wire_bytes, "RC007", cls,
                  "a fused/sharded collective must override wire_bytes: the per-edge x "
                  "degree default does not describe its traffic")
    if proto.sharded:
        ck.expect(cls.host_wire_bytes is not ExchangeProtocol.host_wire_bytes, "RC007", cls,
                  "sharded=True but host_wire_bytes is the one-edge-payload default; a "
                  "shard scatter publishes P payloads per step")

    ck.rule = "RC008"  # sharded <=> shard surface
    shard_api = all(callable(getattr(proto, m, None))
                    for m in ("plan", "host_encode_shard", "host_decode_shard"))
    ck.expect(shard_api == proto.sharded, "RC008", cls,
              f"sharded={proto.sharded} but the shard surface (plan / host_encode_shard / "
              f"host_decode_shard) is {'present' if shard_api else 'missing'}")
    if proto.sharded and shard_api:
        plan = proto.plan(tree, ctx)
        ck.expect(int(plan.num_shards) == _P, "RC008", cls,
                  f"plan produced {plan.num_shards} shards for {_P} peers: the sharded "
                  "exchange owns one shard per peer")
        row = plan.shards(tree)[0]
        wire, _ = proto.host_encode_shard(row, ctx)
        back = proto.host_decode_shard(wire, ctx)
        ck.expect(bool(torch.allclose(back.to(torch.float32), row.to(torch.float32))),
                  "RC008", cls, "shard encode/decode roundtrip changed values")

    ck.rule = "RC009"  # spec parameter parsing
    if name in PARAM_EXCHANGE_SAMPLES:
        ck.expect(ck.raises(lambda: get_exchange(spec)) is False, "RC009", cls,
                  f"sample spec {spec!r} was rejected by get_exchange")
    else:
        rejected = ck.raises(lambda: get_exchange(f"{name}:1"))
        ck.expect(rejected is True, "RC009", cls,
                  f"{name}:1 must be rejected with a clean ValueError (got "
                  f"{'no error' if rejected is False else 'a non-ValueError'})")


def _check_graphs(ck: _Checker) -> None:
    for name in graph.available_graphs():
        ck.guarded(graph._REGISTRY[name], lambda: _check_graph(ck, name, 8))


def _check_graph(ck: _Checker, name: str, P: int) -> None:
    StaticGraph, get_graph = graph.StaticGraph, graph.get_graph
    ck.rule = "RC009"
    if name == "static":
        # construction by name is (correctly) refused: build an explicit
        # instance for the structural checks instead
        refused = ck.raises(lambda: get_graph("static", P, seed=0))
        ck.expect(refused is True, "RC009", StaticGraph,
                  "get_graph('static', P) must refuse with ValueError: the static overlay "
                  "needs an explicit adjacency")
        g = StaticGraph.from_edges(P, [(i, (i + 1) % P) for i in range(P)])
    else:
        spec = f"{name}:{PARAM_GRAPH_SAMPLES[name]}" if name in PARAM_GRAPH_SAMPLES else name
        g = get_graph(spec, P, seed=0)
    cls = type(g)
    ck.rule = "RC001"
    ck.expect(g.name == name, "RC001", cls, f"registered as {name!r} but cls.name is {g.name!r}")
    ck.rule = "RC010"
    adj = np.asarray(g.adjacency, bool)
    ck.expect(bool((adj == adj.T).all()), "RC010", cls,
              "adjacency is not symmetric: the P2P overlay is undirected")
    ck.expect(not adj.diagonal().any(), "RC010", cls,
              "adjacency has self-loops; a peer is not its own neighbor")
    ck.expect(bool(g.is_connected()), "RC010", cls,
              f"overlay is disconnected at P={P}; gossip averaging cannot reach consensus")
    W = np.asarray(g.mixing_matrix(), np.float64)
    ck.expect(bool(np.allclose(W.sum(axis=1), 1.0) and np.allclose(W, W.T)), "RC010", cls,
              "Metropolis–Hastings mixing matrix is not doubly stochastic")
    ck.rule = "RC013"  # the sparse surface against the dense oracles
    ck.expect(all(np.array_equal(g.neighbors_array(r), np.flatnonzero(adj[r])) for r in range(P)),
              "RC013", cls, "neighbors_array(r) disagrees with the dense adjacency row")
    ck.expect(all(np.array_equal(g.mixing_row(r), np.asarray(g.mixing_matrix())[r])
                  for r in range(P)),
              "RC013", cls, "lazy mixing_row(r) is not bit-equal to mixing_matrix()[r]")
    ck.expect(bool(np.array_equal(g.degrees, adj.sum(axis=1))), "RC013", cls,
              "CSR degrees disagree with dense adjacency row sums")
    x = np.random.default_rng(0).standard_normal(P)
    ck.expect(bool(np.allclose(g.mix_apply(x), W @ x, atol=1e-12)), "RC013", cls,
              "sparse mix_apply(x) disagrees with the dense W @ x")
    ck.expect(abs(g.spectral_gap(method="power") - g.spectral_gap(method="dense")) <= 1e-6,
              "RC013", cls, "power-iteration spectral gap drifts from the eigvalsh oracle")
    ck.rule = "RC009"  # a name without a parameter rejects one cleanly
    if name not in PARAM_GRAPH_SAMPLES and name != "static":
        rejected = ck.raises(lambda: get_graph(f"{name}:2", P, seed=0))
        ck.expect(rejected is True, "RC009", cls,
                  f"{name}:2 must be rejected with a clean ValueError (got "
                  f"{'no error' if rejected is False else 'a non-ValueError'})")


def _check_allocations(ck: _Checker) -> None:
    for name in events.available_allocations():
        ck.guarded(events._ALLOC_REGISTRY[name], lambda: _check_allocation(ck, name))


def _check_allocation(ck: _Checker, name: str) -> None:
    ck.rule = "RC001"
    pol = events.get_allocation(name)
    cls = type(pol)
    ck.expect(pol.name == name, "RC001", cls, f"registered as {name!r} but cls.name is {pol.name!r}")
    ck.rule = "RC011"
    got = pol.memory_mb(epoch=0, planned_mb=1792, history=[])
    ck.expect(got == 1792, "RC011", cls,
              f"with no fan-out history the policy must fall back to the planner's static "
              f"fit (1792 MB), got {got}")


def _check_cross_registry(ck: _Checker) -> None:
    registries = {
        "exchange": set(exchange.available_exchanges()),
        "graph": set(graph.available_graphs()),
        "allocation": set(events.available_allocations()),
    }
    for n in sorted(set().union(*registries.values())):
        owners = sorted(k for k, v in registries.items() if n in v)
        ck.checks_run += 1
        if len(owners) > 1:
            ck.findings.append(Finding(
                rule="RC012", severity="info", path="<registries>", line=1,
                message=(f"name {n!r} is registered in multiple registries "
                         f"({', '.join(owners)}); namespaces are distinct but a spec "
                         "string's meaning now depends on position"),
                pass_name=PASS_NAME,
            ))


def contracts_pass() -> Tuple[List[Finding], int]:
    """Run every registry contract; returns ``(findings, checks_run)``."""
    ck = _Checker()
    _check_exchange(ck)
    _check_graphs(ck)
    _check_allocations(ck)
    _check_cross_registry(ck)
    return ck.findings, ck.checks_run
