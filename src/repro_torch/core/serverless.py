"""Serverless gradient offload — paper §III-C / §IV-D.

Two halves:

* :class:`ServerlessPlanner` — sizes the Lambda pool for a workload: memory
  per function (from the model + batch footprint, mirroring the paper's
  per-batch-size memory column in Table II), number of invocations, and the
  Step-Functions-style dynamic fan-out plan.
* :class:`ServerlessExecutor` — executes a peer's per-batch gradient
  computations. The math runs for real (the gradient returned is exact);
  wall-clock is *accounted* under the chosen backend:
    - "instance": resource-constrained sequential processing (the paper's
      PyTorch-on-small-EC2 baseline) -> sum of batch times.
    - "serverless": parallel Lambda fan-out -> max of batch times, scaled by
      the Lambda/instance speed ratio, plus invocation + orchestration
      overheads.
  ``run`` synchronises the device of each batch's outputs before it reads
  the clock, so a batch time includes the device work the batch queued.

Since the ServerlessRuntime refactor the executor no longer owns a time
model: wall-clock comes from a discrete-event fan-out simulation on
:class:`repro_torch.core.events.ServerlessRuntime` (cold/warm container pools,
concurrency caps, retries, stragglers), and per-epoch memory sizing is
delegated to a pluggable :class:`repro_torch.core.events.AllocationPolicy`.
The default :class:`repro_torch.core.events.RuntimeConfig` is ideal (no faults,
no cold starts, unbounded concurrency) and reproduces the legacy analytic
accounting to float precision.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.cost import (
    CostReport,
    ServerlessCost,
    ec2_cost_per_second,
    lambda_cost_per_second,
    working_set_mb,
)
from repro_torch.core.events import (
    AllocationPolicy,
    FanoutResult,
    InstanceConfig,
    InstanceEpochResult,
    InvocationRecord,
    LinkModel,
    RuntimeConfig,
    ServerlessRuntime,
    get_allocation,
)
from repro_torch.core.instance import InstanceRuntime, instance_speedup, instance_splits

LAMBDA_MAX_MEMORY_MB = 10_240  # AWS cap (paper §III-A)
LAMBDA_TIMEOUT_S = 15 * 60
LAMBDA_MB_PER_VCPU = 1_769  # AWS: 1 vCPU per 1769 MB
DEPLOY_ZIP_CAP_MB = 50
DEPLOY_UNZIPPED_CAP_MB = 250


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)


def block_until_ready(tree) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree`` (nested
    dicts, lists and tuples): the reference's ``jax.block_until_ready``.
    CPU tensors are ready when the call that made them returns."""
    for device in sorted({t.device.index for t in _tensors(tree) if t.is_cuda}):
        torch.cuda.synchronize(device)


def lambda_speedup(memory_mb: int, instance_vcpus: float) -> float:
    """Lambda vCPU share relative to the baseline instance (floored at 0.25:
    even tiny functions make some progress)."""
    return max((memory_mb / LAMBDA_MB_PER_VCPU) / instance_vcpus, 0.25)


@dataclass(frozen=True)
class LambdaSpec:
    memory_mb: int
    speedup_vs_instance: float  # Lambda vCPUs / instance vCPUs available

    @property
    def vcpus(self) -> float:
        return self.memory_mb / LAMBDA_MB_PER_VCPU


@dataclass(frozen=True)
class StepFunctionPlan:
    """The dynamically generated parallel state machine (paper §IV-D.3)."""

    num_branches: int
    lambda_spec: LambdaSpec
    payload_keys: Tuple[str, ...]  # S3 batch keys, one per branch

    def asl_sketch(self) -> Dict[str, Any]:
        """Amazon-States-Language-shaped dict (for docs/tests)."""
        return {
            "StartAt": "ParallelGradients",
            "States": {
                "ParallelGradients": {
                    "Type": "Map",
                    "MaxConcurrency": self.num_branches,
                    "ItemsPath": "$.batches",
                    "Iterator": {
                        "StartAt": "ComputeBatchGradient",
                        "States": {
                            "ComputeBatchGradient": {
                                "Type": "Task",
                                "Resource": "arn:aws:lambda:::function:grad",
                                "End": True,
                            }
                        },
                    },
                    "End": True,
                }
            },
        }


class ServerlessPlanner:
    """Sizes Lambda memory like the paper: the minimum that fits the model,
    activations for one batch, and the runtime, rounded up to 64 MB."""

    def __init__(self, *, runtime_overhead_mb: int = 700):
        self.runtime_overhead_mb = runtime_overhead_mb

    def lambda_memory_mb(self, model_bytes: int, batch_bytes: int) -> int:
        # params + grads + activations + runtime (shared sizing model)
        need = working_set_mb(model_bytes, batch_bytes, self.runtime_overhead_mb)
        mb = int(math.ceil(need / 64.0) * 64)
        if mb > LAMBDA_MAX_MEMORY_MB:
            raise ValueError(
                f"workload needs {mb} MB > Lambda cap {LAMBDA_MAX_MEMORY_MB} MB"
            )
        return max(mb, 128)

    def plan(
        self,
        *,
        model_bytes: int,
        batch_bytes: int,
        num_batches: int,
        instance_vcpus: float = 1.0,
        batch_keys: Optional[Sequence[str]] = None,
    ) -> StepFunctionPlan:
        mem = self.lambda_memory_mb(model_bytes, batch_bytes)
        spec = LambdaSpec(
            memory_mb=mem,
            speedup_vs_instance=lambda_speedup(mem, instance_vcpus),
        )
        keys = tuple(batch_keys or (f"batch-{i:05d}" for i in range(num_batches)))
        return StepFunctionPlan(num_batches, spec, keys)


@dataclass
class ExecutionReport:
    backend: str
    wall_time_s: float  # accounted wall-clock under the backend model
    measured_compute_s: float  # actual CPU time spent on the gradients
    per_batch_s: List[float]
    num_batches: int
    lambda_memory_mb: int = 0
    cost_usd: float = 0.0
    # -- runtime-engine accounting (serverless backend) ---------------------
    epoch: int = 0
    num_cold_starts: int = 0
    cold_start_s: float = 0.0  # total container init time across invocations
    queue_wait_s: float = 0.0  # total concurrency-throttle wait
    num_retries: int = 0
    retry_s: float = 0.0  # dead work + backoff recovering from failures
    billed_lambda_s: float = 0.0  # Lambda-billed seconds across all attempts
    request_fee_usd: float = 0.0  # per-request fee incl. retried invocations
    egress_bytes: int = 0  # exchange bytes moved on the overlay this epoch
    egress_usd: float = 0.0
    download_s: float = 0.0  # payload fetch time (sharded aggregator pieces)
    invocations: List[InvocationRecord] = field(default_factory=list)
    # -- instance-runtime accounting (instance backend) ---------------------
    instance: str = ""  # EC2 tier (baseline VM / serverless orchestrator)
    boot_s: float = 0.0  # VM provisioning time paid this epoch (billed)
    idle_s: float = 0.0  # billed-but-idle seconds (barrier wait)
    downtime_s: float = 0.0  # unbilled churn gaps (no VM running)
    churn_drops: int = 0
    num_splits: int = 1  # micro-batches per batch under memory pressure
    wire_s: float = 0.0  # exchange upload + degree-many downloads
    instance_billed_s: float = 0.0  # EC2-billed seconds (boot+busy+idle)

    def cost_report(self, *, num_peers: int = 1, label: str = "") -> CostReport:
        """This epoch's point on the cost–time frontier — the common
        currency that makes serverless and instance accounting directly
        comparable (``repro_torch.core.cost.compare_backends``)."""
        return CostReport(
            backend=self.backend,
            wall_time_s=self.wall_time_s,
            cost_usd=self.cost_usd,
            instance=self.instance,
            lambda_memory_mb=self.lambda_memory_mb,
            num_peers=num_peers,
            label=label,
        )


class ServerlessExecutor:
    """Runs per-batch gradient thunks; time/cost comes from the runtime engine.

    ``run`` measures the real per-batch compute, then hands the measured
    times to :meth:`simulate`, which prices them under the configured
    :class:`~repro_torch.core.events.ServerlessRuntime` (cold starts, concurrency
    queueing, retries, stragglers) with the Lambda memory chosen per epoch
    by the :class:`~repro_torch.core.events.AllocationPolicy`.
    """

    def __init__(
        self,
        *,
        backend: str = "serverless",  # "serverless" | "instance"
        planner: Optional[ServerlessPlanner] = None,
        instance: str = "t2.small",
        instance_vcpus: float = 1.0,
        invoke_overhead_s: float = 0.15,  # warm-start + S3 batch fetch
        orchestration_overhead_s: float = 0.30,  # Step Functions state machine
        runtime: Union[RuntimeConfig, ServerlessRuntime, None] = None,
        allocation: Union[str, AllocationPolicy] = "static",
        instance_config: Union[InstanceConfig, InstanceRuntime, None] = None,
    ):
        if backend not in ("serverless", "instance"):
            raise ValueError(
                f"backend must be 'serverless' or 'instance', got {backend!r}"
            )
        self.backend = backend
        self.planner = planner or ServerlessPlanner()
        self.instance = instance
        self.instance_vcpus = instance_vcpus
        self.invoke_overhead_s = invoke_overhead_s
        self.orchestration_overhead_s = orchestration_overhead_s
        if isinstance(runtime, ServerlessRuntime):
            self.runtime = runtime
        else:
            self.runtime = ServerlessRuntime(runtime)
        # The instance-baseline counterpart of `runtime`: a discrete-event
        # VM fleet (boot, per-second billing, churn). The ideal default
        # reproduces the legacy Formula-(2) closed form exactly.
        if isinstance(instance_config, InstanceRuntime):
            self.instance_runtime = instance_config
        else:
            self.instance_runtime = InstanceRuntime(
                instance_config, instance=instance
            )
        if isinstance(allocation, str):
            allocation = get_allocation(allocation)
        self.allocation: AllocationPolicy = allocation
        # per-peer fan-out history, the allocation policy's observation stream
        self.history: Dict[Any, List[FanoutResult]] = {}
        # per-peer instance-epoch history (the VM fleet's observation stream)
        self.instance_history: Dict[Any, List[InstanceEpochResult]] = {}

    # ------------------------------------------------------------------
    def _memory_mb(self, planned_mb: int, epoch: int, peer: Any) -> int:
        """Policy suggestion clamped to [fit floor, Lambda cap], 64 MB tiers."""
        mem = self.allocation.memory_mb(
            epoch=epoch, planned_mb=planned_mb, history=self.history.get(peer, ()),
        )
        mem = max(planned_mb, min(int(mem), LAMBDA_MAX_MEMORY_MB))
        return int(math.ceil(mem / 64.0) * 64)

    def simulate(
        self,
        per_batch_s: Sequence[float],
        *,
        model_bytes: int,
        batch_bytes: int,
        epoch: Optional[int] = None,
        peer: Any = 0,
        egress_bytes: int = 0,
        usd_per_gb_egress: float = 0.0,
        memory_mb: Optional[int] = None,
    ) -> ExecutionReport:
        """Account measured instance-side batch times under the runtime.

        This is the accounting half of :meth:`run`, usable on its own when
        the math already happened elsewhere (batch times measured by
        another run). ``egress_bytes`` is the peer's
        degree-aware exchange traffic for the epoch (per-edge payload x
        overlay degree, from ``ExchangeProtocol.wire_bytes``); it is billed
        at ``usd_per_gb_egress`` on top of the Lambda formula.
        ``memory_mb`` pins this peer's Lambda tier explicitly (a
        ``FleetPlan`` assignment), bypassing the allocation policy; it is
        still clamped to [fit floor, Lambda cap] on the 64 MB grid.
        """
        per_batch = [float(t) for t in per_batch_s]
        measured = float(sum(per_batch))
        if epoch is None:
            epoch = len(self.history.get(peer, ()))
        plan = self.planner.plan(
            model_bytes=model_bytes,
            batch_bytes=batch_bytes,
            num_batches=len(per_batch),
            instance_vcpus=self.instance_vcpus,
        )
        if memory_mb is None:
            mem = self._memory_mb(plan.lambda_spec.memory_mb, epoch, peer)
        else:
            mem = max(
                plan.lambda_spec.memory_mb,
                min(int(memory_mb), LAMBDA_MAX_MEMORY_MB),
            )
            mem = int(math.ceil(mem / 64.0) * 64)
        speed = lambda_speedup(mem, self.instance_vcpus)
        lam_times = [t / speed + self.invoke_overhead_s for t in per_batch]
        if lam_times and max(lam_times) > LAMBDA_TIMEOUT_S:
            raise ValueError(
                f"a batch needs {max(lam_times):.0f}s on a "
                f"{mem}MB Lambda — exceeds the "
                f"{LAMBDA_TIMEOUT_S}s cap (paper §III-A); shrink the batch "
                "or raise memory"
            )
        res = self.runtime.fanout(
            [t / speed for t in per_batch],
            memory_mb=mem,
            function_key=peer,
            invoke_overhead_s=self.invoke_overhead_s,
            timeout_s=LAMBDA_TIMEOUT_S,
        )
        self.history.setdefault(peer, []).append(res)
        wall = self.orchestration_overhead_s + res.makespan_s
        cost = ServerlessCost(
            compute_time_s=wall,
            num_batches=len(per_batch),
            lambda_memory_mb=mem,
            instance=self.instance,
            num_retries=res.num_retries,
            retry_billed_s=sum(r.failed_s for r in res.invocations),
            cold_start_billed_s=res.cold_start_s_total,
            egress_bytes=egress_bytes,
            usd_per_gb_egress=usd_per_gb_egress,
        )
        return ExecutionReport(
            backend="serverless",
            wall_time_s=wall,
            measured_compute_s=measured,
            per_batch_s=per_batch,
            num_batches=len(per_batch),
            lambda_memory_mb=mem,
            cost_usd=cost.cost_per_peer,
            epoch=epoch,
            num_cold_starts=res.num_cold_starts,
            cold_start_s=res.cold_start_s_total,
            queue_wait_s=res.queue_wait_s_total,
            num_retries=res.num_retries,
            retry_s=res.retry_s_total,
            billed_lambda_s=res.billed_s_total,
            request_fee_usd=cost.request_fee_usd,
            egress_bytes=egress_bytes,
            egress_usd=cost.egress_usd,
            invocations=res.invocations,
            instance=self.instance,
        )

    def simulate_aggregation(
        self,
        per_shard_s: Sequence[float],
        *,
        shard_bytes: int,
        num_contributions: int,
        epoch: Optional[int] = None,
        peer: Any = "aggregate",
        link=None,
        usd_per_gb_egress: float = 0.0,
    ) -> ExecutionReport:
        """Price P parallel serverless aggregators under the runtime engine.

        The sharded-exchange aggregation stage (SPIRT / LambdaML): one
        Lambda invocation PER SHARD, all submitted concurrently, each
        downloading its ``num_contributions - 1`` foreign shard pieces
        (charged via ``link``) and reducing ``shard_bytes`` worth of
        parameters per contribution. Cold starts, stragglers, concurrency
        caps, and retries apply per shard; the
        :class:`~repro_torch.core.events.AllocationPolicy` sizes aggregator
        memory from SHARD bytes — not model bytes — so doubling the peer
        count halves both the aggregation makespan and the memory tier.

        ``per_shard_s`` are instance-side measured reduce times, one per
        shard (``len(per_shard_s)`` = the shard count P).
        """
        per_shard = [float(t) for t in per_shard_s]
        key = ("agg", peer)
        if epoch is None:
            epoch = len(self.history.get(key, ()))
        # Aggregator footprint: the shard accumulator + one incoming piece
        # + runtime — the planner's model slot holds the shard, not the
        # model, which is the whole point of sharding the aggregation.
        planned = self.planner.lambda_memory_mb(
            model_bytes=int(shard_bytes), batch_bytes=int(shard_bytes)
        )
        mem = self._memory_mb(planned, epoch, key)
        speed = lambda_speedup(mem, self.instance_vcpus)
        dl_bytes = max(num_contributions - 1, 0) * int(shard_bytes)
        res = self.runtime.fanout(
            [t / speed for t in per_shard],
            memory_mb=mem,
            function_key=key,
            invoke_overhead_s=self.invoke_overhead_s,
            timeout_s=LAMBDA_TIMEOUT_S,
            download_bytes=[dl_bytes] * len(per_shard),
            link=link,
        )
        self.history.setdefault(key, []).append(res)
        wall = self.orchestration_overhead_s + res.makespan_s
        egress_bytes = dl_bytes * len(per_shard)
        cost = ServerlessCost(
            compute_time_s=wall,
            num_batches=len(per_shard),
            lambda_memory_mb=mem,
            instance=self.instance,
            num_retries=res.num_retries,
            retry_billed_s=sum(r.failed_s for r in res.invocations),
            cold_start_billed_s=res.cold_start_s_total,
            egress_bytes=egress_bytes,
            usd_per_gb_egress=usd_per_gb_egress,
        )
        return ExecutionReport(
            backend="serverless",
            wall_time_s=wall,
            measured_compute_s=float(sum(per_shard)),
            per_batch_s=per_shard,
            num_batches=len(per_shard),
            lambda_memory_mb=mem,
            cost_usd=cost.cost_per_peer,
            epoch=epoch,
            num_cold_starts=res.num_cold_starts,
            cold_start_s=res.cold_start_s_total,
            queue_wait_s=res.queue_wait_s_total,
            num_retries=res.num_retries,
            retry_s=res.retry_s_total,
            billed_lambda_s=res.billed_s_total,
            request_fee_usd=cost.request_fee_usd,
            egress_bytes=egress_bytes,
            egress_usd=cost.egress_usd,
            download_s=sum(r.download_s for r in res.invocations),
            invocations=res.invocations,
            instance=self.instance,
        )

    def simulate_instance(
        self,
        per_batch_s: Sequence[float],
        *,
        model_bytes: int = 0,
        batch_bytes: int = 0,
        epoch: Optional[int] = None,
        peer: Any = 0,
        reference_vcpus: Optional[float] = None,
        upload_bytes: int = 0,
        download_bytes: Sequence[int] = (),
        link: Optional[LinkModel] = None,
        barrier_wait_s: float = 0.0,
        strict_fit: bool = True,
    ) -> ExecutionReport:
        """Account measured per-batch times under the instance baseline.

        The instance-side mirror of :meth:`simulate`: the same measured
        batch times, priced on :class:`~repro_torch.core.instance.InstanceRuntime`
        — sequential execution on the configured EC2 tier, with boot,
        per-second billing including idle, memory-constrained mini-batch
        splitting (``model_bytes``/``batch_bytes`` against the tier's
        memory), seeded churn, and degree-aware wire charging
        (``upload_bytes`` + one ``download_bytes`` entry per overlay
        neighbor, through ``link``). ``reference_vcpus`` rescales times
        measured on a different machine onto this tier's vCPUs (``None`` =
        already measured here, the legacy convention). The ideal
        :class:`~repro_torch.core.events.InstanceConfig` with no wire/barrier
        charging reproduces the legacy closed form: ``wall = sum(
        per_batch_s)``, ``cost = Formula (2)`` — equivalence-tested.
        """
        per_batch = [float(t) for t in per_batch_s]
        measured = float(sum(per_batch))
        rt = self.instance_runtime
        if epoch is None:
            epoch = len(self.instance_history.get(peer, ()))
        splits = 1
        if model_bytes > 0:
            try:
                splits = instance_splits(
                    model_bytes, batch_bytes, rt.instance,
                    runtime_overhead_mb=self.planner.runtime_overhead_mb,
                )
            except ValueError:
                # the model alone overflows the tier: with strict_fit the
                # scenario is refused (fig10 marks it "does not fit");
                # without, fall back to the legacy no-memory-model
                # accounting (the operator provisioned swap/host memory)
                if strict_fit:
                    raise
                splits = 1
        speed = instance_speedup(rt.instance, reference_vcpus)
        res = rt.run_epoch(
            [t / speed for t in per_batch],
            peer=peer,
            splits=splits,
            upload_bytes=upload_bytes,
            download_bytes=download_bytes,
            link=link,
            barrier_wait_s=barrier_wait_s,
        )
        self.instance_history.setdefault(peer, []).append(res)
        cost = rt.price(res)
        return ExecutionReport(
            backend="instance",
            wall_time_s=res.makespan_s,
            measured_compute_s=measured,
            per_batch_s=per_batch,
            num_batches=len(per_batch),
            cost_usd=cost.cost_per_peer,
            epoch=epoch,
            instance=rt.instance,
            boot_s=res.boot_s,
            idle_s=res.idle_s,
            downtime_s=res.downtime_s,
            churn_drops=res.churn_drops,
            num_splits=res.splits,
            wire_s=res.wire_s,
            instance_billed_s=cost.billed_s,
        )

    def run(
        self,
        grad_thunks: Sequence[Callable[[], Any]],
        *,
        model_bytes: int,
        batch_bytes: int,
        combine: Callable[[List[Any]], Any],
        epoch: Optional[int] = None,
        peer: Any = 0,
    ) -> Tuple[Any, ExecutionReport]:
        """Execute every thunk (exact math), account wall time per backend."""
        results: List[Any] = []
        per_batch: List[float] = []
        for thunk in grad_thunks:
            t0 = time.perf_counter()
            out = thunk()
            block_until_ready(out)
            per_batch.append(time.perf_counter() - t0)
            results.append(out)
        measured = float(sum(per_batch))
        g = combine(results)

        if self.backend == "instance":
            # engine-priced baseline: boot, churn, memory-constrained
            # splitting apply; the ideal default reproduces the legacy
            # closed form (wall = measured, cost = Formula (2)) exactly.
            # strict_fit off: an oversized model falls back to the legacy
            # no-memory-model accounting instead of refusing the epoch
            report = self.simulate_instance(
                per_batch,
                model_bytes=model_bytes,
                batch_bytes=batch_bytes,
                epoch=epoch,
                peer=peer,
                strict_fit=False,
            )
            return g, report

        report = self.simulate(
            per_batch,
            model_bytes=model_bytes,
            batch_bytes=batch_bytes,
            epoch=epoch,
            peer=peer,
        )
        return g, report
