"""The port's sharded exchange against the reference, on the CPU.

* ``ShardPlan``: buffers and shards bit-identical to the reference's for
  the same leaves (leaves in JAX leaf order, convolutions in HWIO), plan
  metadata equal, round trips exact, padding when P exceeds the parameter
  count, the stacked (``lead=1``) form equal to the per-peer one.
* The ``reduce_scatter`` and ``tree[:k]`` combines on the stacked bank
  against the reference's under ``jax.vmap(axis_name="data")``, bit for bit
  in f32 and with a bf16 wire, P = 2..5 and 7. The reference's tree sends
  to some ranks only, which ``jax.vmap`` cannot batch: the test gives its
  ``ppermute`` the collective's own semantics (each target receives its
  source's value, every other rank zeros) through an ``all_gather``.
* ``wire_bytes``, ``wire_bytes_per_edge`` and ``host_wire_bytes`` equal to
  the reference's integers for every new protocol on the paper's three CNNs.
* Host sharded and tree epochs of 4 squeezenet1.1 peers (MNIST-shaped 8x8,
  2 epochs, a serverless executor with the batch and aggregator times
  pinned on both sides) against the reference's: params within 1e-5
  (XLA and oneDNN sum convolution gradients in other orders), mailbox
  statistics, bytes sent, ``comm_cost`` and every ``aggregation_reports``
  field equal; and within 1e-6 of the port's own ``allgather_mean`` run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.core import LocalP2PCluster as JCluster
from repro.core.exchange import ExchangeContext as JContext
from repro.core.exchange import get_exchange as jget_exchange
from repro.core.serverless import ServerlessExecutor as JExecutor
from repro.core.shard import ShardPlan as JShardPlan
from repro.data import make_dataset as jmake_dataset
from repro.models import init_model as jinit_model
from repro.train.checkpoint import _flatten, _path_str
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import LocalP2PCluster, ServerlessExecutor, ShardPlan
from repro_torch.core import exchange as X
from repro_torch.core.tree import TreePlan
from repro_torch.data import make_dataset
from repro_torch.optim import sgd
from test_torch_cluster import _gaps

torch.set_num_threads(2)  # the test workers share the CPU with each other

SHARDED = ("reduce_scatter", "tree", "tree:3")
NEW = SHARDED + ("trimmed_mean", "trimmed_mean:0.25", "median", "krum", "krum:2")


def _tree(seed, lead=(), dtypes=(torch.float32,) * 4):
    """Leaves in the port's layout; a conv, a linear weight, a bias, a scalar."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"conv.w": (6, 3, 3, 3), "fc.w": (5, 7), "fc.b": (5,), "scale": ()}
    return {k: torch.randn((*lead, *s), generator=g).to(dt)
            for (k, s), dt in zip(shapes.items(), dtypes)}


def _nest(flat):
    out = {}
    for k, v in flat.items():
        d = out
        parts = k.split(".")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _jax_tree(tree, lead=0):
    return _nest({k: jnp.asarray(convert.to_jax_layout(v.float(), lead=lead).numpy()).astype(
        {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
         torch.float16: jnp.float16}[v.dtype]) for k, v in tree.items()})


def _bits(a: torch.Tensor, b) -> bool:
    return np.array_equal(a.float().numpy().view(np.uint32), np.asarray(b, np.float32).view(np.uint32))


@pytest.mark.parametrize("P", [1, 2, 3, 4, 8, 19])
def test_shard_plan_buffers_are_the_references(P):
    for dtypes in ((torch.float32,) * 4, (torch.float32, torch.bfloat16, torch.float16,
                                          torch.float32)):
        tree = _tree(P, dtypes=dtypes)
        plan, jplan = ShardPlan.for_tree(tree, P), JShardPlan.for_tree(_jax_tree(tree), P)
        for f in ("shapes", "offsets", "total", "num_shards", "shard_size", "padded_size", "pad",
                  "sizes"):
            assert getattr(plan, f) == getattr(jplan, f), f
        assert str(plan.buffer_dtype).replace("torch.", "") == jplan.buffer_dtype.name
        for wire in (None, torch.float32, torch.bfloat16):
            jwire = None if wire is None else jnp.dtype(str(wire).replace("torch.", ""))
            assert plan.shard_bytes(wire) == jplan.shard_bytes(jwire)
        shards, jshards = plan.shards(tree), jplan.shards(_jax_tree(tree))
        assert shards.shape == jshards.shape == (P, plan.shard_size)
        assert _bits(shards, jshards)
        for i in range(P):
            lo, hi = plan.shard_slice(i)
            assert (lo, hi) == jplan.shard_slice(i)
            assert torch.equal(plan.flatten(tree)[lo:hi], shards[i])
        for back in (plan.unflatten(shards), plan.unflatten(plan.flatten(tree))):
            assert list(back) == convert.jax_order(tree)
            for k, v in tree.items():
                assert back[k].dtype == v.dtype and torch.equal(back[k], v)
        bank = {k: torch.stack([v, 2 * v, -v]) for k, v in tree.items()}
        stacked = plan.flatten(bank, lead=1)
        for r, c in enumerate((1, 2, -1)):
            assert torch.equal(stacked[r], plan.flatten({k: c * v for k, v in tree.items()}))
        back = plan.unflatten(plan.shards(bank, lead=1), lead=1)
        assert all(torch.equal(back[k], bank[k]) for k in bank)
    assert plan.describe().startswith(f"ShardPlan(P={P}, ")


def test_more_shards_than_params_pads_and_round_trips():
    tree = {"b": torch.tensor([1.5, -2.0, 3.25])}
    plan = ShardPlan.for_tree(tree, 8)
    assert (plan.total, plan.shard_size, plan.pad, plan.padded_size) == (3, 1, 5, 8)
    shards = plan.shards(tree)
    assert shards[:3, 0].tolist() == [1.5, -2.0, 3.25] and not shards[3:].any()
    assert torch.equal(plan.unflatten(shards)["b"], tree["b"])


def test_shard_plan_refuses_what_the_reference_refuses():
    tree = _tree(0)
    with pytest.raises(ValueError, match="num_shards"):
        ShardPlan.for_tree(tree, 0)
    plan = ShardPlan.for_tree(tree, 4)
    with pytest.raises(ValueError, match="leaves"):
        plan.flatten({"fc.b": tree["fc.b"]})
    with pytest.raises(ValueError, match="plan expects"):
        plan.unflatten(torch.zeros(plan.padded_size + 1))
    with pytest.raises(IndexError):
        plan.shard_slice(4)
    # shapes only: a plan of meta tensors prices a gradient it never holds
    meta = {k: torch.empty(v.shape, device="meta") for k, v in tree.items()}
    assert ShardPlan.for_tree(meta, 4) == plan


_ppermute = lax.ppermute


def _ppermute_any(x, axis_name, perm):
    """``lax.ppermute``'s semantics for a partial permutation under vmap:
    each target receives its source's value, every other rank zeros."""
    perm = list(perm)
    n = lax.psum(1, axis_name)
    if len(perm) == n:
        return _ppermute(x, axis_name, perm)
    src = np.full(n, -1)
    for i, j in perm:
        src[j] = i
    s = jnp.asarray(src)[lax.axis_index(axis_name)]
    gathered = lax.all_gather(x, axis_name)
    return jnp.where(s >= 0, gathered[jnp.maximum(s, 0)], jnp.zeros_like(x))


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", SHARDED)
def test_sharded_combine_is_the_references_bit_for_bit(monkeypatch, name, wire):
    monkeypatch.setattr(lax, "ppermute", _ppermute_any)
    for P in (2, 3, 4, 5, 7):
        bank = _tree(10 + P, lead=(P,))
        bank["fc.b"][min(1, P - 1), 0] = -0.0  # a negative zero the sums must keep or lose alike
        proto, jproto = X.get_exchange(name), jget_exchange(name)
        ctx = X.ExchangeContext(num_peers=P, wire_dtype=getattr(torch, wire))
        jctx = JContext(axis="data", num_peers=P, wire_dtype=jnp.dtype(wire))
        theirs = jax.vmap(lambda g: jproto.combine(g, jctx)[0], axis_name="data")(
            _jax_tree(bank, lead=1))
        ours, state = proto.combine(bank, ctx)
        assert state is None
        flat = dict(zip(convert.jax_order(bank), jax.tree_util.tree_leaves(theirs)))
        for k, v in ours.items():
            assert v.shape == bank[k].shape and v.dtype == torch.float32
            assert _bits(convert.to_jax_layout(v, lead=1), flat[k]), (name, wire, P, k)


def test_sharded_combines_refuse_a_sparse_overlay():
    from repro_torch.core.graph import get_graph

    g = get_graph("ring", 4)
    ctx = X.ExchangeContext(num_peers=4, graph=g, mixing=g.mixing_matrix())
    for name in SHARDED:
        with pytest.raises(ValueError, match="graph='full'"):
            X.get_exchange(name).combine(_tree(0, lead=(4,)), ctx)


def test_tree_plan_is_the_references():
    from repro.core.tree import TreePlan as JTreePlan

    for P in (1, 2, 3, 4, 7, 13):
        for k in (2, 3, 4):
            a, b = TreePlan(P, k), JTreePlan(P, k)
            assert (a.depth, a.num_hubs, a.describe()) == (b.depth, b.num_hubs, b.describe())
            assert a.levels() == b.levels()
            for r in range(P):
                assert (a.parent(r), a.children(r), a.level_of(r)) == (
                    b.parent(r), b.children(r), b.level_of(r))
    with pytest.raises(ValueError, match="fanout"):
        TreePlan(4, 1)


def _paper_grads(arch):
    """The paper CNN's gradient shapes, as the port's meta tensors and the
    reference's ShapeDtypeStructs."""
    cfg = jget_config(arch)
    shapes = jax.eval_shape(lambda: jinit_model(jax.random.PRNGKey(0), cfg))
    port = {
        ".".join(_path_str(p) for p in path): convert.to_torch_layout(
            torch.empty(leaf.shape, device="meta"))
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
    }
    return port, shapes


@pytest.mark.parametrize("arch", ["vgg11", "mobilenet-v3-small", "squeezenet1.1"])
def test_wire_bytes_are_the_references_on_the_paper_cnns(arch):
    grads, jgrads = _paper_grads(arch)
    for P in (3, 4):
        for wire in ("float32", "bfloat16"):
            ctx = X.ExchangeContext(num_peers=P, wire_dtype=getattr(torch, wire))
            jctx = JContext(num_peers=P, wire_dtype=jnp.dtype(wire))
            for name in NEW:
                p, q = X.get_exchange(name), jget_exchange(name)
                got = (p.wire_bytes_per_edge(grads, ctx), p.wire_bytes(grads, ctx),
                       p.host_wire_bytes(grads, ctx))
                assert got == (q.wire_bytes_per_edge(jgrads, jctx), q.wire_bytes(jgrads, jctx),
                               q.host_wire_bytes(jgrads, jctx)), (name, P, wire)
                assert all(isinstance(x, int) and x > 0 for x in got)


PINNED = 0.25  # seconds: every batch and every aggregator's reduce, on both sides


def _pinned(base):
    """The executor with measured times replaced by ``PINNED``: the runtime
    engine then sees the same work on both sides."""
    class Pinned(base):
        def simulate(self, per_batch_s, **kw):
            return super().simulate([PINNED] * len(per_batch_s), **kw)

        def simulate_aggregation(self, per_shard_s, **kw):
            return super().simulate_aggregation([PINNED] * len(per_shard_s), **kw)

    return Pinned(backend="serverless", allocation="latency")


def _pair(exchange, epochs=2):
    common = dict(num_peers=4, batch_size=8, batches_per_epoch=1, lr=0.05, seed=0,
                  exchange=exchange)
    ref = JCluster(
        jget_config("squeezenet1.1"), jmake_dataset("mnist", size=128, image_hw=8, channels=1),
        optimizer=joptim.sgd(momentum=0.9), executor=_pinned(JExecutor), **common,
    )
    init = convert.from_jax(_flatten(ref.peers[0].params), device="cpu")
    port = LocalP2PCluster(
        get_config("squeezenet1.1"), make_dataset("mnist", size=128, image_hw=8, channels=1),
        optimizer=sgd(momentum=0.9), executor=_pinned(ServerlessExecutor), init_params=init,
        device="cpu", **common,
    )
    for e in range(epochs):
        ref.run_epoch_sync(e)
        port.run_epoch_sync(e)
    return ref, port


@pytest.mark.parametrize("exchange", SHARDED)
def test_host_sharded_epochs_are_the_references(exchange):
    ref, port = _pair(exchange)
    assert _gaps(ref, port).max() <= 1e-5
    assert port.mailbox.stats == ref.mailbox.stats
    assert port.mailbox.live_messages == ref.mailbox.live_messages
    assert [p.comm_bytes_sent for p in port.peers] == [p.comm_bytes_sent for p in ref.peers]
    assert [(p.send_time_s, p.recv_time_s, p.steps_done) for p in port.peers] == [
        (p.send_time_s, p.recv_time_s, p.steps_done) for p in ref.peers]
    assert port.shard_plan.shapes == ref.shard_plan.shapes
    assert port.shard_plan.shard_size == ref.shard_plan.shard_size
    for usd in (0.0, 0.09):
        assert dataclasses.asdict(port.comm_cost(usd_per_gb=usd)) == \
            dataclasses.asdict(ref.comm_cost(usd_per_gb=usd))
    # reduce_scatter: one wave of 4 shard aggregators an epoch; tree:2 at
    # P = 4: hubs 1 (over rank 3) and 0 (over 1 and 2), one wave a level;
    # tree:3: the root alone
    waves = {"reduce_scatter": 1, "tree": 2, "tree:3": 1}[exchange]
    assert len(port.aggregation_reports) == len(ref.aggregation_reports) == 2 * waves
    for a, b in zip(port.aggregation_reports, ref.aggregation_reports):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for p, q in zip(port.peers, ref.peers):
        assert [dataclasses.asdict(r) for r in p.reports] == [dataclasses.asdict(r) for r in q.reports]
    if exchange == "reduce_scatter":
        assert [r.num_batches for r in port.aggregation_reports] == [4, 4]


def test_host_sharded_epochs_match_allgather_mean():
    """The equivalence rail: the sharded and tree means are the peer mean up
    to float re-association (within 1e-6), on the port alone."""
    runs = {}
    for exchange in ("allgather_mean",) + SHARDED:
        cl = LocalP2PCluster(
            get_config("squeezenet1.1"), make_dataset("mnist", size=96, image_hw=8, channels=1),
            num_peers=3, batch_size=8, batches_per_epoch=1, optimizer=sgd(momentum=0.9),
            lr=0.05, exchange=exchange, seed=0, device="cpu",
        )
        cl.run(2)
        runs[exchange] = cl
    base = runs.pop("allgather_mean")
    for name, cl in runs.items():
        for a, b in zip(base.peers, cl.peers):
            gap = max(float((a.params[k] - b.params[k]).abs().max()) for k in a.params)
            assert gap <= 1e-6, (name, gap)
    assert runs["reduce_scatter"].mailbox.live_messages == 3 * 3  # (P-1) pieces + 1 agg, x P
    assert runs["tree"].mailbox.live_messages == 3  # ranks 1, 2 up; the root's down
