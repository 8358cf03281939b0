"""The port's event engine, serverless runtime and allocation policies
against the reference's ``repro/core/events.py``, on the CPU.

Both sides are numpy code drawing the same seeded streams in the same
order, so everything is compared exactly: the fire order of seeded random
schedules, every field of a fan-out's ``FanoutResult`` (each invocation's
record included) on the scalar and the batched engine, the records a
``FanoutTimeout`` leaves, the memory sequences of the allocation policies,
and the trace digest of the reference's faulty serverless scenario.
"""
import dataclasses

import numpy as np
import pytest

from repro.analysis.trace import TraceRecorder as JTraceRecorder
from repro.analysis.trace import _run_serverless as _jrun_serverless
from repro.analysis.trace import check_trace as jcheck_trace
from repro.core import events as J
from repro_torch.analysis.trace import TraceRecorder, _run_serverless, check_trace, diff_runs
from repro_torch.core import events as E

FAULTY = dict(concurrency_limit=3, cold_start_s=1.5, failure_rate=0.3,
              straggler_prob=0.3, straggler_slowdown=2.0, seed=7)
CONFIGS = {
    "ideal": lambda m: m.RuntimeConfig.ideal(),
    "aws": lambda m: m.RuntimeConfig.aws_default(),
    "faulty": lambda m: m.RuntimeConfig(**FAULTY),
}


def _schedule(module, seed, tracer=None):
    """A seeded random schedule on ``module``'s engine, with callbacks that
    schedule more events; returns the fire log and the engine."""
    plan = np.random.default_rng(seed)
    engine = module.EventEngine(seed=seed, tracer=tracer)
    fired = []

    def event(tag, depth):
        def fire():
            fired.append((tag, engine.now, float(engine.rng.random())))
            if depth < 2:
                for j in range(int(plan.integers(0, 3))):
                    engine.schedule_in(float(plan.choice([0.0, 0.5, plan.random()])),
                                       event(f"{tag}.{j}", depth + 1),
                                       priority=int(plan.integers(0, 3)))
        return fire

    for i in range(12):
        engine.schedule_at(float(plan.choice([0.0, 1.0, plan.random() * 3])), event(str(i), 0),
                           priority=int(plan.integers(0, 3)))
    engine.run()
    return fired, engine


@pytest.mark.parametrize("seed", range(6))
def test_engine_fires_seeded_schedules_in_the_reference_order(seed):
    ours, theirs = TraceRecorder(), JTraceRecorder()
    fired, engine = _schedule(E, seed, ours)
    jfired, jengine = _schedule(J, seed, theirs)
    assert fired == jfired
    assert (engine.now, engine.processed) == (jengine.now, jengine.processed)
    assert ours.events == theirs.events and ours.digest() == theirs.digest()


def test_engine_reset_refuses_pending_events():
    engine = E.EventEngine()
    engine.schedule_at(1.0, lambda: None)
    with pytest.raises(RuntimeError, match="pending"):
        engine.reset()
    engine.run()
    engine.reset(2.5)
    assert engine.now == 2.5


def _times(n, seed=0):
    return list(np.random.default_rng(seed).uniform(0.2, 1.5, size=n))


def _fanouts(module, config, n, batched, **kw):
    rt = module.ServerlessRuntime(CONFIGS[config](module))
    # three epochs: warm pools, the deployment clock and the RNG carry over
    return [rt.fanout(_times(n, e), memory_mb=1024, invoke_overhead_s=0.15, batched=batched,
                      **kw) for e in range(3)], rt.clock


@pytest.mark.parametrize("n", [6, 255, 300])
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("batched", [False, True, None])
def test_fanout_equals_the_reference(config, n, batched):
    ours, clock = _fanouts(E, config, n, batched)
    theirs, jclock = _fanouts(J, config, n, batched)
    assert clock == jclock
    for a, b in zip(ours, theirs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.num_cold_starts, a.num_retries, a.cold_start_s_total, a.queue_wait_s_total,
                a.retry_s_total, a.billed_s_total, a.max_exec_s) == (
            b.num_cold_starts, b.num_retries, b.cold_start_s_total, b.queue_wait_s_total,
            b.retry_s_total, b.billed_s_total, b.max_exec_s)


def test_batched_fanout_is_the_scalar_fanout():
    scalar, _ = _fanouts(E, "faulty", 300, False)
    batched, _ = _fanouts(E, "faulty", 300, True)
    assert [dataclasses.asdict(r) for r in scalar] == [dataclasses.asdict(r) for r in batched]


def test_fanout_downloads_are_charged_as_the_reference():
    kw = dict(download_bytes=[2_000_000] * 6)
    ours, _ = _fanouts(E, "aws", 6, None, link=E.LinkModel(1e9, 0.01), **kw)
    theirs, _ = _fanouts(J, "aws", 6, None, link=J.LinkModel(1e9, 0.01), **kw)
    assert [dataclasses.asdict(r) for r in ours] == [dataclasses.asdict(r) for r in theirs]


@pytest.mark.parametrize("batched", [False, True])
def test_fanout_timeout_leaves_the_reference_records(batched):
    def run(module):
        rt = module.ServerlessRuntime(module.RuntimeConfig(failure_rate=0.9, max_retries=1,
                                                           cold_start_s=2.0, seed=3))
        with pytest.raises(module.FanoutTimeout) as err:
            rt.fanout([1.0, 4.0, 2.0] * 100, memory_mb=512, timeout_s=3.0, batched=batched)
        return str(err.value), rt.clock, rt.fanouts_run

    assert run(E) == run(J)


@pytest.mark.parametrize("name,kw", [
    ("static", {}),
    ("latency", {}),
    ("latency", dict(target_batch_s=0.4, shrink_threshold=0.8)),
    ("aimd", {}),
])
def test_allocation_policies_size_memory_as_the_reference(name, kw):
    # the reference's own policies: tests/test_events.py registers test
    # policies in the reference's registry, which show here when the two
    # files share a worker
    assert E.available_allocations() == tuple(
        n for n in J.available_allocations() if J._ALLOC_REGISTRY[n].__module__ == J.__name__)

    def sizes(module):
        policy = module.get_allocation(name, **kw)
        rt = module.ServerlessRuntime(module.RuntimeConfig.aws_default())
        history, out = [], []
        for epoch in range(6):
            mem = policy.memory_mb(epoch=epoch, planned_mb=1024, history=history)
            out.append(mem)
            scale = 1769.0 / max(mem, 128)
            history.append(rt.fanout([t * scale for t in _times(8, epoch)], memory_mb=int(mem)))
        return out, policy.describe()

    assert sizes(E) == sizes(J)


def test_unknown_allocation_is_refused():
    with pytest.raises(ValueError):
        E.get_allocation("nope")


def test_instance_config_presets_are_the_reference():
    for preset in ("ideal", "aws_default"):
        assert dataclasses.asdict(getattr(E.InstanceConfig, preset)()) == \
            dataclasses.asdict(getattr(J.InstanceConfig, preset)())
    assert dataclasses.asdict(E.InstanceConfig.gpu_default(120.0)) == \
        dataclasses.asdict(J.InstanceConfig.gpu_default(120.0))
    assert E.BATCHED_FANOUT_MIN == J.BATCHED_FANOUT_MIN == 256


def test_faulty_serverless_trace_digest_is_the_reference():
    ours, theirs = TraceRecorder(), JTraceRecorder()
    _run_serverless(ours)
    _jrun_serverless(theirs)
    assert len(ours) == len(theirs) > 50
    assert ours.events == theirs.events
    assert ours.digest() == theirs.digest()
    findings, first = diff_runs("serverless-fanout-faulty", _run_serverless)
    assert findings == [] and first.digest() == ours.digest()
    mine = [dataclasses.astuple(f) for f in check_trace(ours.events, label="x")]
    assert mine == [dataclasses.astuple(f) for f in jcheck_trace(theirs.events, label="x")]
    assert {f[0] for f in mine} <= {"RT002"}  # engine ties only, by design


def test_check_trace_flags_what_the_reference_flags():
    events = [
        ("engine", ("seeded", False), ("time", 0.0)),
        ("publish", ("actor", 0), ("epoch", 1), ("shard", None)),
        ("publish", ("actor", 0), ("epoch", 1), ("shard", None)),
        ("fire", ("priority", 0), ("time", 1.0)),
        ("fire", ("priority", 0), ("time", 1.0)),
        ("consume", ("peer", 0), ("shard", None)),
        ("publish", ("actor", 0), ("epoch", 1), ("shard", None)),
    ]
    mine = [dataclasses.astuple(f) for f in check_trace(events)]
    assert [f[0] for f in mine] == ["RT004", "RT001", "RT002"]
    assert mine == [dataclasses.astuple(f) for f in jcheck_trace(events)]
