"""The port's cost model, instance runtime, serverless planner and executor,
and fleet scheduler against the reference's (``repro/core/cost.py``,
``instance.py``, ``serverless.py``, ``scheduler.py``), on the CPU.

Both sides are numpy and float arithmetic in the same order on the same
seeded streams, so results are compared exactly, field for field
(``dataclasses.asdict``), trace digests included. The executor's ``run``
is held to the reference's accounting on the batch times it measured
(``simulate`` on the same list), and its device synchronisation to the
thunks' outputs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis.trace import TraceRecorder as JTraceRecorder
from repro.core import cost as JC
from repro.core import events as JE
from repro.core import instance as JI
from repro.core import scheduler as JS
from repro.core import serverless as JSV
from repro_torch.analysis.trace import TraceRecorder
from repro_torch.core import cost as C
from repro_torch.core import events as E
from repro_torch.core import instance as I
from repro_torch.core import scheduler as S
from repro_torch.core import serverless as SV

PAPER_BATCHES = (1024, 512, 128, 64)
MODEL, BATCH = int(50e6), int(4e6)
FAULTY = dict(concurrency_limit=3, cold_start_s=1.5, failure_rate=0.3,
              straggler_prob=0.3, straggler_slowdown=2.0, seed=7)


def _per_batch(n, seed=0):
    return [float(t) for t in np.random.default_rng(seed).uniform(0.3, 1.2, size=n)]


def _same(a, b):
    """Dataclass results equal field for field (lists of records too)."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


def test_price_tables_are_the_reference():
    for name in ("LAMBDA_USD_PER_GB_S_ARM", "LAMBDA_USD_PER_REQUEST", "EC2_USD_PER_HOUR",
                 "EC2_MEMORY_MB", "EC2_VCPUS", "GPU_USD_PER_HOUR", "GPU_MEMORY_MB",
                 "GPU_SPEEDUP", "GPU_BOOT_S", "INSTANCE_USD_PER_HOUR", "INSTANCE_MEMORY_MB",
                 "TPU_V5E_USD_PER_CHIP_HOUR"):
        assert getattr(C, name) == getattr(JC, name), name
    for tier in C.INSTANCE_USD_PER_HOUR:
        assert C.ec2_cost_per_second(tier) == JC.ec2_cost_per_second(tier)
        assert C.is_gpu_instance(tier) == JC.is_gpu_instance(tier)
        assert C.instance_equivalent_vcpus(tier) == JC.instance_equivalent_vcpus(tier)
    for mb in (128, 1700, 4400, 10240):
        assert C.lambda_cost_per_second(mb) == JC.lambda_cost_per_second(mb)
    assert C.working_set_mb(MODEL, BATCH, 700) == JC.working_set_mb(MODEL, BATCH, 700)


@pytest.mark.parametrize("batch", PAPER_BATCHES)
def test_paper_tables_and_their_costs_are_the_reference(batch):
    r2, r3 = C.paper_table2_row(batch), C.paper_table3_row(batch)
    assert (r2, r3) == (JC.paper_table2_row(batch), JC.paper_table3_row(batch))

    def points(m):
        s = m.ServerlessCost(r2["compute_time_s"], r2["num_batches"], r2["lambda_memory_mb"],
                             "t2.small", num_retries=2, retry_billed_s=1.5,
                             cold_start_billed_s=2.5, egress_bytes=10**9, usd_per_gb_egress=0.09)
        i = m.InstanceCost(r3["compute_time_s"], "t2.large", boot_s=40.0, idle_s=3.0,
                           unbilled_downtime_s=7.0)
        sr = m.CostReport("serverless", s.compute_time_s, s.cost_per_peer,
                          lambda_memory_mb=r2["lambda_memory_mb"], num_peers=4, label=str(batch))
        ir = m.CostReport("instance", i.wall_time_s, i.cost_per_peer, instance="t2.large")
        return ((s.lambda_cost_s, s.request_fee_usd, s.egress_usd, s.cost_per_peer),
                (i.billed_s, i.wall_time_s, i.cost_per_peer),
                m.compare_backends(sr, ir, sr), sr.summary(), ir.summary(), sr.total_usd)

    assert points(C) == points(JC)


def test_comm_and_tpu_costs_are_the_reference():
    kw = dict(wire_bytes_per_step=123_456_789, bandwidth_bps=1e9, usd_per_gb_egress=0.09,
              bytes_per_edge=41_152_263, degree=3.0, graph_name="full")
    for extra in ({}, dict(num_shards=4, shard_bytes=30_864_197)):
        a, b = C.CommCost(**kw, **extra), JC.CommCost(**kw, **extra)
        assert (a.seconds_per_step, a.usd_per_step, a.summary()) == (
            b.seconds_per_step, b.usd_per_step, b.summary())
    assert C.TPUCost(8.4, 256).cost_per_step == JC.TPUCost(8.4, 256).cost_per_step


def test_frontier_and_dominance_are_the_reference():
    rng = np.random.default_rng(3)
    pts = [(float(rng.choice([1.0, 2.0, rng.random() * 3])),
            float(rng.choice([0.5, rng.random()])), f"p{i}") for i in range(40)]
    ours = [C.CostReport("serverless", w, c, label=l) for w, c, l in pts]
    theirs = [JC.CostReport("serverless", w, c, label=l) for w, c, l in pts]
    assert [p.label for p in C.pareto_frontier(ours)] == [p.label for p in JC.pareto_frontier(theirs)]
    assert [[C.dominates(a, b) for b in ours] for a in ours] == \
        [[JC.dominates(a, b) for b in theirs] for a in theirs]


# ---------------------------------------------------------------------------
# instance runtime
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["t2.small", "t2.large", "g4dn.xlarge"])
@pytest.mark.parametrize("model_mb,batch_mb", [(5, 4), (500, 160), (900, 40)])
def test_instance_splits_and_speedup_are_the_reference(tier, model_mb, batch_mb):
    def splits(f):
        try:
            return f(int(model_mb * 1e6), int(batch_mb * 1e6), tier)
        except ValueError as e:
            return str(e)

    assert splits(I.instance_splits) == splits(JI.instance_splits)
    for ref in (None, 1.0, 2.0):
        assert I.instance_speedup(tier, ref) == JI.instance_speedup(tier, ref)


@pytest.mark.parametrize("config", [
    dict(),
    dict(boot_s=40.0, churn_prob=0.3, churn_downtime_s=5.0, seed=4),
])
def test_instance_runtime_epochs_and_trace_are_the_reference(config):
    def run(em, im, tm):
        tracer = tm()
        rt = im.InstanceRuntime(em.InstanceConfig(**config), instance="t2.large", tracer=tracer)
        out = []
        for epoch in range(3):
            res = rt.run_epoch(_per_batch(6, epoch), peer=epoch % 2, splits=1 + epoch,
                               upload_bytes=4_000_000, download_bytes=[4_000_000] * 3,
                               link=em.LinkModel(1e9), barrier_wait_s=0.25 * epoch)
            out.append((dataclasses.asdict(res), res.billed_s, dataclasses.asdict(rt.price(res))))
        return out, rt.clock, tracer.digest()

    assert run(E, I, TraceRecorder) == run(JE, JI, JTraceRecorder)


# ---------------------------------------------------------------------------
# planner and executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model_mb", [5, 50, 500, 2000, 4000])
def test_planner_sizes_and_plans_as_the_reference(model_mb):
    ours, theirs = SV.ServerlessPlanner(), JSV.ServerlessPlanner()
    assert ours.lambda_memory_mb(int(model_mb * 1e6), BATCH) == \
        theirs.lambda_memory_mb(int(model_mb * 1e6), BATCH)
    plan = ours.plan(model_bytes=int(model_mb * 1e6), batch_bytes=BATCH, num_batches=5,
                     instance_vcpus=2.0)
    jplan = theirs.plan(model_bytes=int(model_mb * 1e6), batch_bytes=BATCH, num_batches=5,
                        instance_vcpus=2.0)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    assert plan.asl_sketch() == jplan.asl_sketch()
    assert plan.lambda_spec.vcpus == jplan.lambda_spec.vcpus


def test_planner_refuses_what_lambda_cannot_hold():
    with pytest.raises(ValueError, match="Lambda cap"):
        SV.ServerlessPlanner().lambda_memory_mb(int(6e9), BATCH)
    for mb in (128, 1769, 10240):
        assert SV.lambda_speedup(mb, 1.0) == JSV.lambda_speedup(mb, 1.0)


def _executors(m, em, **kw):
    return m.ServerlessExecutor(runtime=em.RuntimeConfig(**FAULTY), **kw)


@pytest.mark.parametrize("allocation", ["static", "latency", "aimd"])
def test_simulate_is_the_reference(allocation):
    def run(m, em):
        ex = _executors(m, em, allocation=allocation, instance="t2.medium", instance_vcpus=2.0)
        return [ex.simulate(_per_batch(16, e), model_bytes=MODEL, batch_bytes=BATCH, peer=e % 2,
                            egress_bytes=3_000_000, usd_per_gb_egress=0.09)
                for e in range(4)]

    for a, b in zip(run(SV, E), run(JSV, JE)):
        _same(a, b)
        _same(a.cost_report(num_peers=4, label="x"), b.cost_report(num_peers=4, label="x"))


def test_simulate_pins_a_memory_tier_and_refuses_a_timeout():
    for m, em in ((SV, E), (JSV, JE)):
        rep = _executors(m, em).simulate(_per_batch(4), model_bytes=MODEL, batch_bytes=BATCH,
                                         memory_mb=3000)
        assert rep.lambda_memory_mb == 3008
    for m, em in ((SV, E), (JSV, JE)):
        with pytest.raises(ValueError, match="exceeds"):
            _executors(m, em).simulate([2000.0], model_bytes=MODEL, batch_bytes=BATCH)


def test_simulate_aggregation_is_the_reference():
    def run(m, em):
        ex = _executors(m, em, allocation="latency")
        return [ex.simulate_aggregation(_per_batch(4, e), shard_bytes=12_000_000,
                                        num_contributions=4, link=em.LinkModel(1e9, 0.002),
                                        usd_per_gb_egress=0.02) for e in range(3)]

    for a, b in zip(run(SV, E), run(JSV, JE)):
        _same(a, b)


@pytest.mark.parametrize("config,tier", [
    ("ideal", "t2.large"), ("aws", "t2.small"), ("gpu", "g4dn.xlarge"),
])
def test_simulate_instance_is_the_reference(config, tier):
    def run(m, em):
        cfg = {"ideal": em.InstanceConfig.ideal(), "aws": em.InstanceConfig.aws_default(),
               "gpu": em.InstanceConfig.gpu_default()}[config]
        ex = m.ServerlessExecutor(backend="instance", instance=tier, instance_config=cfg)
        out = [ex.simulate_instance(_per_batch(8, e), model_bytes=int(500e6), batch_bytes=int(160e6),
                                    reference_vcpus=1.0, upload_bytes=2_000_000,
                                    download_bytes=[2_000_000] * 3, link=em.LinkModel(1e9),
                                    barrier_wait_s=0.5, strict_fit=False) for e in range(3)]
        out.append(ex.simulate_instance(_per_batch(8)))  # the legacy closed form
        return out

    for a, b in zip(run(SV, E), run(JSV, JE)):
        _same(a, b)


def test_executor_refuses_an_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        SV.ServerlessExecutor(backend="tpu")


@pytest.mark.parametrize("backend", ["serverless", "instance"])
def test_run_times_each_batch_and_prices_it_as_simulate(backend, monkeypatch):
    """``run`` executes every thunk, synchronises the device of each
    output, and prices the times it measured exactly as the reference's
    ``simulate`` / ``simulate_instance`` price them."""
    synced = []
    monkeypatch.setattr(SV, "block_until_ready", lambda out: synced.append(out))
    outs = [({"w": torch.full((3,), float(i))}, torch.tensor(0.5 * i)) for i in range(5)]
    thunks = [(lambda o=o: o) for o in outs]
    ex = SV.ServerlessExecutor(backend=backend, runtime=E.RuntimeConfig.aws_default())
    g, rep = ex.run(thunks, model_bytes=MODEL, batch_bytes=BATCH,
                    combine=lambda rs: sum(r[0]["w"] for r in rs), epoch=0, peer=1)
    assert synced == outs
    torch.testing.assert_close(g, torch.full((3,), 10.0))
    assert rep.num_batches == 5 and len(rep.per_batch_s) == 5
    assert rep.measured_compute_s == sum(rep.per_batch_s) and min(rep.per_batch_s) > 0
    jex = JSV.ServerlessExecutor(backend=backend, runtime=JE.RuntimeConfig.aws_default())
    if backend == "serverless":
        jrep = jex.simulate(rep.per_batch_s, model_bytes=MODEL, batch_bytes=BATCH, epoch=0, peer=1)
    else:
        jrep = jex.simulate_instance(rep.per_batch_s, model_bytes=MODEL, batch_bytes=BATCH,
                                     epoch=0, peer=1, strict_fit=False)
    _same(rep, jrep)


def test_block_until_ready_synchronises_each_cuda_device_once(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    SV.block_until_ready(({"a": torch.zeros(2), "b": [torch.ones(1)]}, torch.tensor(1.0)))
    assert calls == []  # CPU tensors: nothing to wait for
    cuda = type("T", (), {"is_cuda": True, "device": torch.device("cuda", 1)})
    monkeypatch.setattr(SV, "_tensors", lambda tree: iter([cuda, cuda, cuda]))
    SV.block_until_ready(None)
    assert calls == [1]


# ---------------------------------------------------------------------------
# fleets and schedulers
# ---------------------------------------------------------------------------


def test_standard_candidates_are_the_reference():
    for peers in (1, 2, 4, 5):
        ours, theirs = S.standard_candidates(peers), JS.standard_candidates(peers)
        assert [dataclasses.asdict(p) for p in ours] == [dataclasses.asdict(p) for p in theirs]
        assert [p.describe() for p in ours] == [p.describe() for p in theirs]


def _workload(plan):
    return [_per_batch(4 + 2 * r, r) for r in range(plan.num_peers)]


@pytest.mark.parametrize("warm", [False, True])
def test_evaluate_candidates_and_schedulers_pick_as_the_reference(warm):
    def run(m, em, tm):
        tracer = tm()
        reps = m.evaluate_candidates(m.standard_candidates(4), _workload, model_bytes=MODEL,
                                     batch_bytes=BATCH, warm=warm,
                                     runtime=em.RuntimeConfig.aws_default(), tracer=tracer)
        picks = []
        for name in m.available_schedulers():
            for kw in (dict(deadline_s=2.0), dict(budget_usd=1e-3), {},
                       dict(deadline_s=0.01, budget_usd=1e-9)):
                try:
                    picks.append(m.get_scheduler(name).choose(reps, **kw))
                except ValueError as e:
                    picks.append(str(e))
        return [dataclasses.asdict(r) for r in reps], picks, tracer.digest()

    assert S.available_schedulers() == JS.available_schedulers()
    assert run(S, E, TraceRecorder) == run(JS, JE, JTraceRecorder)


@pytest.mark.parametrize("faulty", [False, True])
def test_fleet_epoch_digest_is_the_reference(faulty):
    def run(m, em, tm):
        plan = m.FleetPlan((
            m.PeerAssignment("instance", instance="p3.2xlarge"),
            m.PeerAssignment("instance", instance="t2.large"),
            m.PeerAssignment("serverless"),
            m.PeerAssignment("serverless", memory_mb=4400),
        ), name="gpu+cpu+sls")
        tracer = tm()
        fx = m.FleetExecutor(
            runtime=em.RuntimeConfig.aws_default() if faulty else em.RuntimeConfig(seed=3),
            instance_config=(em.InstanceConfig(boot_s=5.0, churn_prob=0.3, churn_downtime_s=2.0,
                                               seed=3) if faulty else None),
            tracer=tracer,
        )
        workload = [[6.0, 6.0], [1.0] * 4, [0.5] * 8, [0.5] * 8]
        reports = [fx.run_epoch(plan, workload, model_bytes=MODEL, batch_bytes=BATCH)
                   for _ in range(2)]
        return ([dataclasses.asdict(r) for r in reports],
                [dataclasses.asdict(r.cost_report(label="f")) for r in reports], tracer.digest())

    ours, theirs = run(S, E, TraceRecorder), run(JS, JE, JTraceRecorder)
    assert ours[2] == theirs[2]
    assert ours == theirs


def test_fleet_refuses_what_the_reference_refuses():
    for m in (S, JS):
        with pytest.raises(ValueError):
            m.FleetPlan(())
        with pytest.raises(ValueError):
            m.FleetExecutor().run_epoch(m.FleetPlan.pure("serverless", 2), [[1.0]],
                                        model_bytes=MODEL, batch_bytes=BATCH)
        with pytest.raises(ValueError):
            m.get_scheduler("nope")
