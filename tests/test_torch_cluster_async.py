"""The port's asynchronous, executor-priced and traced ``LocalP2PCluster``
and its ``async`` exchange protocol against the reference, on the CPU.

* The reference's churned async scenario (``repro.analysis.trace``'s
  ``_run_cluster``: squeezenet1.1, 2 peers, churn 0.3, ``sim_compute_s``
  pinned, seed 11, 2 epochs) from the same init: the same events (trace
  digest), processing order, drops, downtime and clocks; params within
  1e-5 (XLA and oneDNN sum convolution gradients in other orders).
* Async epochs of 4 peers at speeds (1, 1.25, 1.5, 2), ``allgather_mean``
  and ``async`` through ``run``: the same processing order, clocks, wire
  accounting and history; params within 1e-5
  (``test_torch_cluster_async_qsgd.py`` and
  ``test_torch_cluster_async_topk.py`` run QSGD and top-k).
* An executor (serverless or instance) leaves the params bit-identical to
  the same run without one, and fills the reports and simulated stages.
* ``comm_cost`` equals the reference's for every ported protocol on the
  full and the ring graph (the sharded ones with the shard plan a cluster
  built for them holds).
* The ``async`` device combine on the stacked bank equals the reference's
  ``StalenessMailbox.combine`` under ``jax.vmap(axis_name="data")``
  within 1e-6 for K = 1, 2, 3 on both graphs, ring state included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.analysis.trace import TraceRecorder as JTraceRecorder
from repro.configs import get_config as jget_config
from repro.core import LocalP2PCluster as JCluster
from repro.core.compression import QSGDConfig as JQSGDConfig
from repro.core.exchange import ExchangeContext as JContext
from repro.core.exchange import get_exchange as jget_exchange
from repro.core.graph import get_graph as jget_graph
from repro.data import BatchKey as JBatchKey
from repro.data import make_dataset as jmake_dataset
from repro.train.checkpoint import _flatten
from repro_torch import convert
from repro_torch.analysis.trace import TraceRecorder, _run_cluster, check_trace
from repro_torch.configs import get_config
from repro_torch.core import (
    InstanceConfig,
    LocalP2PCluster,
    QSGDConfig,
    RuntimeConfig,
    ServerlessExecutor,
)
from repro_torch.core import exchange as X
from repro_torch.core.graph import get_graph
from repro_torch.data import make_dataset
from repro_torch.optim import sgd
from test_torch_cluster import _gaps
from test_torch_cluster_qsgd import _replay_reference_uniforms
from test_torch_topk import _jleaves, _leaf_tree, _to_jax_tree

torch.set_num_threads(2)  # the test workers share the CPU with each other

LR = 0.05
SPEEDS = (1.0, 1.25, 1.5, 2.0)


def _sim_compute(rank, epoch):
    return 0.1 + 0.01 * rank + 0.001 * epoch


def _pair(exchange, graph="full", qsgd=None, **kw):
    """The reference's and the port's 4-peer squeezenet clusters, same init."""
    common = dict(num_peers=4, batch_size=8, batches_per_epoch=1, lr=LR, seed=0,
                  exchange=exchange, graph=graph, **kw)
    ref = JCluster(
        jget_config("squeezenet1.1"), jmake_dataset("mnist", size=128, image_hw=8, channels=1),
        optimizer=joptim.sgd(momentum=0.9),
        qsgd=None if qsgd is None else JQSGDConfig(*qsgd), **common,
    )
    init = convert.from_jax(_flatten(ref.peers[0].params), device="cpu")
    port = LocalP2PCluster(
        get_config("squeezenet1.1"), make_dataset("mnist", size=128, image_hw=8, channels=1),
        optimizer=sgd(momentum=0.9), qsgd=None if qsgd is None else QSGDConfig(*qsgd),
        init_params=init, device="cpu", **common,
    )
    return ref, port


def _same_async_accounting(ref, port):
    assert port.last_event_order == ref.last_event_order
    assert port.mailbox.stats == ref.mailbox.stats
    for a, b in zip(port.peers, ref.peers):
        assert (a.clock, a.drops, a.downtime_s, a.steps_done, a.comm_bytes_sent,
                a.send_time_s, a.recv_time_s) == (
            b.clock, b.drops, b.downtime_s, b.steps_done, b.comm_bytes_sent,
            b.send_time_s, b.recv_time_s)


def test_churned_async_scenario_has_the_reference_trace():
    jtracer, tracer = JTraceRecorder(), TraceRecorder()
    ref = JCluster(
        jget_config("squeezenet1.1"), jmake_dataset("mnist", size=64, image_hw=8, channels=1),
        num_peers=2, batch_size=8, batches_per_epoch=1, optimizer=joptim.sgd(momentum=0.0),
        lr=0.05, sync=False, churn_prob=0.3, churn_downtime_s=0.5,
        sim_compute_s=lambda rank, epoch: 0.1 + 0.01 * rank, tracer=jtracer, seed=11,
    )
    init = convert.from_jax(_flatten(ref.peers[0].params), device="cpu")
    for epoch in range(2):
        ref.run_epoch_async(epoch)
    port = _run_cluster(tracer, device="cpu", init_params=init)
    assert len(tracer) == len(jtracer) > 10
    assert tracer.events == jtracer.events
    assert tracer.digest() == jtracer.digest()
    assert check_trace(tracer.events) == []
    assert sum(p.drops for p in port.peers) > 0  # churn struck
    _same_async_accounting(ref, port)
    assert _gaps(ref, port).max() <= 1e-5


@pytest.mark.parametrize("exchange", ["async", "allgather_mean"])
def test_run_dispatches_async_epochs_as_the_reference(exchange):
    ref, port = _pair(exchange, sync=False, peer_speeds=SPEEDS, sim_compute_s=_sim_compute)
    r_hist, p_hist = ref.run(2), port.run(2)
    assert [h["epoch"] for h in p_hist] == [h["epoch"] for h in r_hist] == [0, 1]
    for a, b in zip(p_hist, r_hist):
        np.testing.assert_allclose([a[k] for k in ("loss", "val_loss")],
                                   [b[k] for k in ("loss", "val_loss")], rtol=1e-5)
    _same_async_accounting(ref, port)
    assert _gaps(ref, port).max() <= 1e-5


def _cluster(executor=None, **kw):
    return LocalP2PCluster(
        get_config("squeezenet1.1"), make_dataset("mnist", size=128, image_hw=8, channels=1),
        num_peers=4, batch_size=8, batches_per_epoch=3, optimizer=sgd(momentum=0.9), lr=LR,
        exchange="topk", topk_frac=0.05, ef=True, seed=0, executor=executor, device="cpu", **kw,
    )


@pytest.mark.parametrize("backend", ["serverless", "instance"])
def test_executor_leaves_params_bit_identical(backend):
    executor = ServerlessExecutor(
        backend=backend, runtime=RuntimeConfig.aws_default(), allocation="latency",
        instance="t2.large", instance_config=InstanceConfig.aws_default(),
    )
    plain, priced = _cluster(), _cluster(executor)
    plain.run(2)
    priced.run(2)
    for a, b in zip(plain.peers, priced.peers):
        assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
        assert all(torch.equal(a.ef[k], b.ef[k]) for k in a.ef)
        assert b.reports and len(b.reports) == 2 and not a.reports
        for epoch, rep in enumerate(b.reports):
            assert (rep.backend, rep.epoch, rep.num_batches) == (backend, epoch, 3)
            assert rep.measured_compute_s == sum(rep.per_batch_s) and min(rep.per_batch_s) > 0
            assert rep.wall_time_s > 0 and rep.cost_usd > 0
        stages = ("cold_start", "queue_wait", "retry") if backend == "serverless" else (
            "boot", "churn_downtime")
        for stage in stages:
            assert len(b.metrics.records[stage]) == 2
        assert b.compute_time_s == pytest.approx(sum(r.wall_time_s for r in b.reports))
    rep = priced.peers[0].reports[0]
    if backend == "serverless":
        assert rep.num_cold_starts == 3  # every container of the first epoch is cold
        assert rep.lambda_memory_mb >= 128 and len(rep.invocations) == 3
    else:
        assert rep.boot_s == 40.0 and rep.instance == "t2.large"


def test_executor_prices_what_the_reference_prices_for_the_same_batch_times():
    """The cluster hands the executor the reference's model and batch bytes."""
    ref, port = _pair("allgather_mean", sync=True)
    seen = {}

    class Spy(ServerlessExecutor):
        def run(self, thunks, **kw):
            seen.update(kw, n=len(thunks))
            return super().run(thunks, **kw)

    port.executor = Spy()
    port.run_epoch_sync(0)
    assert seen["model_bytes"] == ref._model_bytes == port._model_bytes
    jbatch = jax.tree.map(jnp.asarray, ref.peers[3].loader.load(JBatchKey(3, 0, 0)))
    assert seen["batch_bytes"] == sum(np.asarray(x).nbytes for x in jbatch.values())
    assert (seen["n"], seen["epoch"], seen["peer"]) == (1, 0, 3)


def test_sim_compute_pins_the_compute_stage():
    port = _cluster(sim_compute_s=0.25)
    port.run_epoch_sync(0)
    assert [p.compute_time_s for p in port.peers] == [0.25] * 4


@pytest.mark.parametrize("graph", ["full", "ring"])
def test_comm_cost_is_the_reference_for_every_ported_protocol(graph):
    ref, port = _pair("allgather_mean", graph, qsgd=(7, 256), topk_frac=0.05)
    names = [n for n in X.available_exchanges()
             if graph == "full" or X.get_exchange(n).decomposes_per_edge]
    assert "async" in names and "qsgd" in names and "topk" in names
    for name in names:
        ref.protocol, port.protocol = jget_exchange(name), X.get_exchange(name)
        if port.protocol.sharded:  # the plan a cluster built for it would hold
            ref.shard_plan = ref.protocol.plan(ref.peers[0].params, ref.xctx)
            port.shard_plan = port.protocol.plan(port.peers[0].params, port.xctx)
        for usd in (0.0, 0.09):
            a, b = port.comm_cost(usd_per_gb=usd), ref.comm_cost(usd_per_gb=usd)
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
            assert a.summary() == b.summary()


@pytest.mark.parametrize("staleness", [1, 2, 3])
@pytest.mark.parametrize("graph,wire", [("full", "float32"), ("ring", "float32"),
                                        ("full", "bfloat16")])
def test_async_combine_matches_the_reference_under_vmap(staleness, graph, wire):
    P = 4
    jgraph, tgraph = jget_graph(graph, P), get_graph(graph, P)
    jmix = None if graph == "full" else jgraph.mixing_matrix().astype(np.float32)
    tmix = None if graph == "full" else tgraph.mixing_matrix().astype(np.float32)
    jctx = JContext(axis="data", num_peers=P, wire_dtype=jnp.dtype(wire), staleness=staleness,
                    graph=jgraph, mixing=jmix)
    ctx = X.ExchangeContext(num_peers=P, wire_dtype=getattr(torch, wire), staleness=staleness,
                            graph=tgraph, mixing=tmix)
    jproto, proto = jget_exchange("async"), X.get_exchange("async")
    assert (proto.is_async, proto.requires_key, proto.lossy) == (
        jproto.is_async, jproto.requires_key, jproto.lossy)
    state = proto.init_state(_leaf_tree(0), ctx)
    jstate = jproto.init_state(_to_jax_tree(_leaf_tree(0)), jctx)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: (staleness, P, *_leaf_tree(0)[k].shape) for k in state}
    step = jax.vmap(lambda g, s: jproto.combine(g, jctx, state=s), in_axes=(0, None),
                    out_axes=(0, None), axis_name="data")
    for t in range(staleness + 2):  # past the ring's length: stale rows arrive
        grads = _leaf_tree(10 + t, peers=P)
        avg, state = proto.combine(grads, ctx, state=state)
        javg, jstate = step(_to_jax_tree(grads, 1), jstate)
        for k, theirs in _jleaves(javg).items():
            got = convert.to_jax_layout(avg[k], lead=1).numpy()
            np.testing.assert_allclose(got, np.asarray(theirs), rtol=0, atol=1e-6, err_msg=k)
        for k, theirs in _jleaves(jstate).items():
            got = convert.to_jax_layout(state[k], lead=2).numpy()
            np.testing.assert_array_equal(got, np.asarray(theirs), err_msg=k)


def test_async_combine_refuses_a_missing_mailbox():
    ctx = X.ExchangeContext(num_peers=4)
    with pytest.raises(ValueError, match="init_mailbox"):
        X.get_exchange("async").combine(_leaf_tree(0, peers=4), ctx)
