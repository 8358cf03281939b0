"""InstanceRuntime — the conventional instance-based P2P baseline,
simulated on the same discrete-event engine as the serverless path.

The paper's central claim is a *comparison*: serverless parallel gradient
computation is up to 97.34% faster than conventional instance-based P2P
training, at up to 5.4x the cost. Until this module existed the repo only
simulated the serverless side with engine fidelity
(:class:`repro_torch.core.events.ServerlessRuntime`) while the instance baseline
was the static closed-form Formula (2) — no boot time, no idle billing, no
resource-constrained sequential computation. SPIRT (arXiv:2309.14148) and
"Towards Demystifying Serverless Machine Learning Training"
(arXiv:2105.07806) both stress that cost–time frontiers are only credible
when the VM baseline is modeled with the same fidelity as the serverless
path. This module is that baseline:

* **Provisioning/boot** — the first epoch (and every churn recovery) pays
  :class:`~repro_torch.core.events.InstanceConfig.boot_s` before any batch runs;
  the VM then stays up across epochs on the runtime's deployment-lifetime
  clock (the instance analogue of the serverless warm-container pool).
* **Per-second billing including idle** — the EC2 meter runs from boot
  start through barrier waits; only churn downtime (no VM exists) is
  unbilled. See :class:`repro_torch.core.cost.InstanceCost.billed_s`.
* **Memory-constrained mini-batch splitting** — when the model + one
  batch's working set exceed the tier's memory
  (:data:`repro_torch.core.cost.EC2_MEMORY_MB`), each batch is split into the
  smallest number of sequential micro-batches that fit, paying a per-split
  gradient-accumulation overhead: the paper's "resource-constrained
  scenario", where the weak instance computes gradients strictly
  sequentially and slower.
* **Peer churn** — reuses the fault machinery idiom of the serverless
  runtime (seeded RNG on the engine, bounded redos): a VM can die
  mid-batch, losing partial work, and rejoin after a downtime on a fresh
  (re-billed) boot.
* **Degree-aware wire charging** — the exchange phase charges one upload
  plus degree-many downloads through the shared
  :class:`~repro_torch.core.events.LinkModel`, so sparse
  :class:`~repro_torch.core.graph.PeerGraph` overlays pay O(degree), exactly as
  the serverless path accounts egress.

Pricing glue lives in :meth:`repro_torch.core.serverless.ServerlessExecutor.
simulate_instance`, which turns an :class:`InstanceEpochResult` into an
``ExecutionReport`` + engine-priced :class:`~repro_torch.core.cost.InstanceCost`
directly comparable (via :class:`~repro_torch.core.cost.CostReport`) with the
serverless accounting.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cost import (
    INSTANCE_MEMORY_MB,
    InstanceCost,
    instance_equivalent_vcpus,
    working_set_mb,
)
from repro_torch.core.events import (
    EventEngine,
    InstanceConfig,
    InstanceEpochResult,
    LinkModel,
)

# Default runtime overhead, matching ServerlessPlanner's default; the
# resident-set formula itself is repro_torch.core.cost.working_set_mb, shared
# with the Lambda planner so the two sizing models cannot drift apart.
INSTANCE_RUNTIME_OVERHEAD_MB = 700


def instance_splits(
    model_bytes: int,
    batch_bytes: int,
    instance: str,
    *,
    runtime_overhead_mb: int = INSTANCE_RUNTIME_OVERHEAD_MB,
) -> int:
    """Micro-batches one batch must be split into to fit the tier's memory.

    Returns the smallest ``k`` such that ``2*model + 3*batch/k + runtime``
    fits in :data:`~repro_torch.core.cost.INSTANCE_MEMORY_MB` (CPU tiers use
    host RAM, GPU tiers use device memory) — 1 when unconstrained (the
    paper's comfortable case), >1 in the resource-constrained scenario.
    Raises when even ``k -> inf`` cannot fit (the model itself overflows
    the tier), mirroring the Lambda-cap check in the planner.
    """
    mem_mb = INSTANCE_MEMORY_MB[instance]
    fixed_mb = working_set_mb(model_bytes, 0, runtime_overhead_mb)
    if fixed_mb > mem_mb:
        raise ValueError(
            f"model needs {fixed_mb:.0f} MB resident > {instance} memory "
            f"{mem_mb} MB; no amount of batch splitting fits it — pick a "
            "larger tier"
        )
    if batch_bytes <= 0:
        return 1
    avail_mb = mem_mb - fixed_mb
    if avail_mb <= 0:  # model exactly fills the tier: no room for any slice
        raise ValueError(
            f"model fills all {mem_mb} MB of {instance}; no memory left for "
            "even one micro-batch slice — pick a larger tier"
        )
    per_batch_mb = working_set_mb(0, batch_bytes)
    if per_batch_mb <= avail_mb:
        return 1
    return int(math.ceil(per_batch_mb / avail_mb))


def instance_speedup(instance: str, reference_vcpus: Optional[float]) -> float:
    """Tier compute speed relative to the machine the per-batch times were
    measured on. ``None`` means "measured on this tier" (the legacy
    convention — no scaling); otherwise the tier's equivalent-vCPU share
    (:func:`repro_torch.core.cost.instance_equivalent_vcpus` — real vCPUs for
    CPU tiers, the calibrated GPU speedup factor for GPU tiers) scales
    linearly with the same 0.25 floor as
    :func:`repro_torch.core.serverless.lambda_speedup`."""
    if reference_vcpus is None:
        return 1.0
    return max(
        instance_equivalent_vcpus(instance) / float(reference_vcpus), 0.25
    )


class InstanceRuntime:
    """Simulates one peer's instance-based epochs on the event engine.

    One runtime instance persists the VM fleet (which peers have booted)
    and the RNG stream across epochs, so boot is paid once per VM lifetime
    — like a long-lived deployment — and a fixed
    :class:`~repro_torch.core.events.InstanceConfig.seed` makes the whole churn
    trajectory deterministic. The serverless counterpart is
    :class:`~repro_torch.core.events.ServerlessRuntime`; both ride the same
    :class:`~repro_torch.core.events.EventEngine`.
    """

    def __init__(
        self,
        config: Optional[InstanceConfig] = None,
        *,
        instance: str = "t2.large",
        split_overhead_s: float = 0.05,  # per extra micro-batch: reload + accumulate
        tracer: Any = None,
    ):
        if instance not in INSTANCE_MEMORY_MB:
            raise ValueError(
                f"unknown instance tier {instance!r}; known tiers: "
                f"{', '.join(sorted(INSTANCE_MEMORY_MB))}"
            )
        self.config = config or InstanceConfig()
        self.instance = instance
        self.split_overhead_s = split_overhead_s
        self.tracer = tracer
        self.rng = np.random.default_rng(self.config.seed)
        self.clock = 0.0  # deployment-lifetime clock; VMs stay up on it
        self.epochs_run = 0
        self._vm_up: Dict[Any, bool] = {}  # peer -> VM currently provisioned

    def run_epoch(
        self,
        exec_times_s: Sequence[float],
        *,
        peer: Any = 0,
        splits: int = 1,
        submit_time: Optional[float] = None,
        upload_bytes: int = 0,
        download_bytes: Sequence[int] = (),
        link: Optional[LinkModel] = None,
        barrier_wait_s: float = 0.0,
    ) -> InstanceEpochResult:
        """Simulate one peer epoch: [boot ->] batches, sequentially, then
        the exchange wire phase and any barrier idle.

        ``exec_times_s`` are this tier's per-batch execution times (already
        vCPU-scaled by the caller; see :func:`instance_speedup`). With
        ``splits > 1`` each batch additionally pays ``(splits - 1) *
        split_overhead_s`` of gradient-accumulation overhead — the
        memory-constrained sequential path. ``upload_bytes`` /
        ``download_bytes`` (with ``link``) charge the exchange: one publish
        plus one download per overlay neighbor, so wire time is O(degree).
        ``barrier_wait_s`` is billed idle (the VM waits, the meter runs).
        """
        cfg = self.config
        if link is None and (upload_bytes or len(download_bytes)):
            raise ValueError(
                "upload_bytes/download_bytes given without a LinkModel; "
                "pass link= so the exchange wire time is actually charged"
            )
        if submit_time is None:
            submit_time = self.clock
        if self.tracer is not None:
            self.tracer.record(
                "instance_epoch",
                instance=self.instance,
                peer=peer,
                batches=len(exec_times_s),
                splits=max(int(splits), 1),
                submit=float(submit_time),
            )
        engine = EventEngine(rng=self.rng, tracer=self.tracer)
        engine.now = float(submit_time)
        res = InstanceEpochResult(splits=max(int(splits), 1))
        times: List[float] = [
            float(t) + (res.splits - 1) * self.split_overhead_s
            for t in exec_times_s
        ]
        state = {"i": 0, "redos": 0}

        def boot(then):
            res.boot_s += cfg.boot_s
            self._vm_up[peer] = True
            engine.schedule_in(cfg.boot_s, then)

        def start_batch():
            if state["i"] >= len(times):
                finish()
                return
            t = times[state["i"]]
            if (
                cfg.churn_prob > 0.0
                and state["redos"] < cfg.max_churn_redos
                and engine.rng.random() < cfg.churn_prob
            ):
                # VM died mid-batch: partial work lost, meter stops, the
                # replacement re-pays boot after the detection gap
                lost = t * engine.rng.random()
                state["redos"] += 1
                res.churn_drops += 1
                res.redo_s += lost
                res.downtime_s += cfg.churn_downtime_s
                self._vm_up.pop(peer, None)
                engine.schedule_in(
                    lost + cfg.churn_downtime_s, lambda: boot(start_batch)
                )
                return
            state["redos"] = 0
            res.compute_s += t
            state["i"] += 1
            engine.schedule_in(t, start_batch)

        def finish():
            wire = 0.0
            if link is not None:
                if upload_bytes:
                    wire += link.transfer_s(int(upload_bytes))
                for nb in download_bytes:
                    wire += link.transfer_s(int(nb))
            res.wire_s = wire
            res.idle_s += float(barrier_wait_s)
            if wire + barrier_wait_s > 0.0:
                engine.schedule_in(wire + barrier_wait_s, lambda: None)

        if self._vm_up.get(peer):
            engine.schedule_at(submit_time, start_batch)
        else:
            boot(start_batch)
        end = engine.run()
        res.makespan_s = end - submit_time
        self.clock = max(self.clock, end)
        self.epochs_run += 1
        return res

    def price(self, res: InstanceEpochResult) -> InstanceCost:
        """Engine-priced Formula (2): busy + boot + idle billed per second
        on this tier; churn downtime extends the wall but not the bill."""
        return InstanceCost(
            compute_time_s=res.compute_s + res.redo_s + res.wire_s,
            instance=self.instance,
            boot_s=res.boot_s,
            idle_s=res.idle_s,
            unbilled_downtime_s=res.downtime_s,
        )
