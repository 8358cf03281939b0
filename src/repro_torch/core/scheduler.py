"""Heterogeneous fleets and the cost-aware auto-scheduler.

A copy of the reference's ``repro/core/scheduler.py``.
``pareto_frontier`` alone makes the cost–time frontier *descriptive*: it plots
pure-serverless vs pure-EC2 points and a human picks one. The 2025
follow-up ("Cost-Performance Analysis: CPU-Based Serverless vs GPU-Based
Training Architectures", PAPERS.md) shows the real decision space is
heterogeneous — CPU serverless vs GPU instances vs mixed fleets — and
"Towards Demystifying Serverless ML Training" (Jiang et al.) shows that
per-workload backend selection, not a fixed choice, is what makes
serverless training economical. This module makes the frontier
*prescriptive*:

* :class:`PeerAssignment` / :class:`FleetPlan` — a per-rank backend map:
  each peer runs on a pinned serverless tier, a CPU instance, or a GPU
  instance (:data:`repro_torch.core.cost.GPU_USD_PER_HOUR` etc.).
* :class:`FleetExecutor` — runs one epoch of a plan on the existing
  engines (:class:`~repro_torch.core.serverless.ServerlessExecutor` for Lambda
  peers, one persistent :class:`~repro_torch.core.instance.InstanceRuntime` per
  instance tier). Epoch wall-clock is the max over heterogeneous per-peer
  makespans; epoch cost is the sum over per-peer bills, with barrier idle
  (the gap to the slowest peer) billed on instance peers — a VM's meter
  runs while it waits, a Lambda's does not.
* :class:`Scheduler` registry (mirroring
  :class:`~repro_torch.core.events.AllocationPolicy`) — policies that re-pick
  the plan each epoch from *measured* :class:`~repro_torch.core.cost.CostReport`
  history: ``cheapest_under_deadline``, ``fastest_under_budget``, and the
  best-effort greedy ``pareto_walk``.

Conventions: per-peer batch times are measured on the 1-vCPU reference
machine (the same baseline ``instance_vcpus`` scales against), so a GPU
peer runs them :func:`repro_torch.core.cost.instance_equivalent_vcpus` times
faster; a deadline constrains the fleet epoch wall-clock
(``CostReport.wall_time_s``); a budget constrains the whole-cluster epoch
cost (``CostReport.total_usd``).
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import (
    Any,
    Callable,
    ClassVar,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    Type,
    Union,
)

from repro_torch.core.cost import (
    GPU_BOOT_S,
    INSTANCE_MEMORY_MB,
    CostReport,
    ec2_cost_per_second,
    is_gpu_instance,
    pareto_frontier,
)
from repro_torch.core.events import InstanceConfig, RuntimeConfig, ServerlessRuntime
from repro_torch.core.instance import InstanceRuntime
from repro_torch.core.serverless import (
    LAMBDA_MAX_MEMORY_MB,
    ExecutionReport,
    ServerlessExecutor,
    ServerlessPlanner,
)

# ---------------------------------------------------------------------------
# FleetPlan — a per-rank backend assignment
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PeerAssignment:
    """Where one rank runs: a Lambda tier or an instance tier.

    ``backend="serverless"`` with ``memory_mb=0`` lets the planner /
    allocation policy size the function; a nonzero ``memory_mb`` pins the
    tier (still clamped to the fit floor and the Lambda cap).
    ``backend="instance"`` requires a tier from
    :data:`repro_torch.core.cost.INSTANCE_MEMORY_MB` — CPU (t2.*) or GPU
    (g4dn/g5/p3) — and takes no ``memory_mb``.
    """

    backend: str  # "serverless" | "instance"
    instance: str = ""  # instance tier; instance backend only
    memory_mb: int = 0  # pinned Lambda tier; serverless backend only

    def __post_init__(self):
        if self.backend not in ("serverless", "instance"):
            raise ValueError(
                f"backend must be 'serverless' or 'instance', got "
                f"{self.backend!r}"
            )
        if self.backend == "instance":
            if self.instance not in INSTANCE_MEMORY_MB:
                raise ValueError(
                    f"unknown instance tier {self.instance!r}; known tiers: "
                    f"{', '.join(sorted(INSTANCE_MEMORY_MB))}"
                )
            if self.memory_mb:
                raise ValueError(
                    "memory_mb is a serverless knob; an instance peer's "
                    "memory is its tier's"
                )
        else:
            if self.instance:
                raise ValueError(
                    "instance is an instance-backend knob; a serverless "
                    "peer has no VM tier"
                )
            if self.memory_mb and not (
                128 <= self.memory_mb <= LAMBDA_MAX_MEMORY_MB
            ):
                raise ValueError(
                    f"memory_mb must be 0 (auto) or in [128, "
                    f"{LAMBDA_MAX_MEMORY_MB}], got {self.memory_mb}"
                )

    @property
    def is_gpu(self) -> bool:
        return self.backend == "instance" and is_gpu_instance(self.instance)

    def describe(self) -> str:
        if self.backend == "serverless":
            return f"lambda:{self.memory_mb or 'auto'}"
        return f"{'gpu' if self.is_gpu else 'cpu'}:{self.instance}"


@dataclass(frozen=True)
class FleetPlan:
    """One epoch's rank → backend map: ``assignments[rank]`` says where
    that peer computes its gradients. Pure plans (every rank identical)
    reproduce the single-backend accounting exactly — the equivalence
    rail in ``tests/test_scheduler.py``."""

    assignments: Tuple[PeerAssignment, ...]
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "assignments", tuple(self.assignments))
        if not self.assignments:
            raise ValueError("a FleetPlan needs at least one peer")

    @staticmethod
    def pure(
        backend: str,
        num_peers: int,
        *,
        instance: str = "",
        memory_mb: int = 0,
        name: str = "",
    ) -> "FleetPlan":
        """Every rank on the same backend/tier — the pure configs as a
        degenerate fleet."""
        a = PeerAssignment(backend, instance=instance, memory_mb=memory_mb)
        return FleetPlan(
            (a,) * int(num_peers), name=name or f"pure-{a.describe()}"
        )

    @property
    def num_peers(self) -> int:
        return len(self.assignments)

    @property
    def is_pure(self) -> bool:
        return len(set(self.assignments)) == 1

    def describe(self) -> str:
        counts: Dict[str, int] = {}
        for a in self.assignments:
            counts[a.describe()] = counts.get(a.describe(), 0) + 1
        parts = [f"{n}x {kind}" for kind, n in sorted(counts.items())]
        return f"{self.name or 'fleet'}[{', '.join(parts)}]"


# ---------------------------------------------------------------------------
# FleetExecutor — one epoch of a mixed fleet on the existing engines
# ---------------------------------------------------------------------------


@dataclass
class FleetReport:
    """One fleet epoch: per-peer engine reports plus the fleet-level
    reduction — wall = max over peers (the sync barrier), cost = sum over
    peers (every peer pays its own bill, idle included)."""

    plan: FleetPlan
    epoch: int
    per_peer: List[ExecutionReport]
    wall_time_s: float  # max over per-peer makespans
    total_usd: float  # sum over per-peer bills (incl. barrier idle)

    def cost_report(self, *, label: str = "") -> CostReport:
        """The fleet's point on the frontier. Pure plans report under
        their real backend name (so single-backend fleets are directly
        comparable to pure reports); mixed plans report
        ``backend="fleet"``. ``cost_usd`` is per peer (``total_usd / P``),
        matching the pure convention."""
        p = self.plan
        a0 = p.assignments[0]
        pure = p.is_pure
        return CostReport(
            backend=a0.backend if pure else "fleet",
            wall_time_s=self.wall_time_s,
            cost_usd=self.total_usd / p.num_peers,
            instance=a0.instance if pure else "",
            lambda_memory_mb=(
                self.per_peer[0].lambda_memory_mb
                if pure and a0.backend == "serverless"
                else 0
            ),
            num_peers=p.num_peers,
            label=label or p.name or p.describe(),
        )


class FleetExecutor:
    """Runs fleet epochs: Lambda peers on one persistent
    :class:`~repro_torch.core.serverless.ServerlessExecutor` (warm pools and
    allocation history keyed per rank), instance peers on one persistent
    :class:`~repro_torch.core.instance.InstanceRuntime` per tier (VM fleets stay
    booted across epochs). GPU tiers default to
    :meth:`~repro_torch.core.events.InstanceConfig.gpu_default` boot figures
    (:data:`repro_torch.core.cost.GPU_BOOT_S`); CPU tiers default to the ideal
    config, matching the ``InstanceRuntime`` default.

    ``tracer`` threads a :class:`repro_torch.analysis.trace.TraceRecorder`
    through every engine underneath, so a mixed epoch is digest-stable
    under a fixed seed exactly like the pure paths.
    """

    def __init__(
        self,
        *,
        runtime: Union[RuntimeConfig, ServerlessRuntime, None] = None,
        instance_config: Optional[InstanceConfig] = None,  # override ALL tiers
        planner: Optional[ServerlessPlanner] = None,
        instance_vcpus: float = 1.0,
        allocation: str = "static",
        invoke_overhead_s: float = 0.15,
        orchestration_overhead_s: float = 0.30,
        tracer: Any = None,
    ):
        self.tracer = tracer
        self.instance_vcpus = instance_vcpus
        self._instance_config = instance_config
        self._planner = planner or ServerlessPlanner()
        self._invoke_overhead_s = invoke_overhead_s
        self._orchestration_overhead_s = orchestration_overhead_s
        if not isinstance(runtime, ServerlessRuntime):
            runtime = ServerlessRuntime(runtime, tracer=tracer)
        self.serverless = ServerlessExecutor(
            backend="serverless",
            planner=self._planner,
            instance_vcpus=instance_vcpus,
            invoke_overhead_s=invoke_overhead_s,
            orchestration_overhead_s=orchestration_overhead_s,
            runtime=runtime,
            allocation=allocation,
        )
        self._per_tier: Dict[str, ServerlessExecutor] = {}
        self.epochs_run = 0

    def _tier_config(self, tier: str) -> InstanceConfig:
        if self._instance_config is not None:
            return self._instance_config
        if is_gpu_instance(tier):
            return InstanceConfig.gpu_default(GPU_BOOT_S[tier])
        return InstanceConfig()

    def instance_executor(self, tier: str) -> ServerlessExecutor:
        """The persistent instance accountant for one tier (VM fleet + RNG
        stream live across epochs, like a long-lived deployment)."""
        if tier not in self._per_tier:
            self._per_tier[tier] = ServerlessExecutor(
                backend="instance",
                planner=self._planner,
                instance=tier,
                instance_vcpus=self.instance_vcpus,
                invoke_overhead_s=self._invoke_overhead_s,
                orchestration_overhead_s=self._orchestration_overhead_s,
                instance_config=InstanceRuntime(
                    self._tier_config(tier), instance=tier, tracer=self.tracer
                ),
            )
        return self._per_tier[tier]

    def run_epoch(
        self,
        plan: FleetPlan,
        per_peer_batch_s: Sequence[Sequence[float]],
        *,
        model_bytes: int,
        batch_bytes: int,
        epoch: Optional[int] = None,
    ) -> FleetReport:
        """One synchronous fleet epoch: every rank computes its own batch
        list on its assigned backend, then all meet at the exchange
        barrier. ``per_peer_batch_s[rank]`` are that rank's reference-
        machine batch times (heterogeneous per-peer workloads are the
        point — see fig14). Instance peers bill their barrier idle (wall
        minus own makespan) at their tier's per-second rate; serverless
        peers bill nothing while idle (the functions already exited)."""
        if len(per_peer_batch_s) != plan.num_peers:
            raise ValueError(
                f"plan has {plan.num_peers} peers but "
                f"{len(per_peer_batch_s)} per-peer batch lists were given"
            )
        if epoch is None:
            epoch = self.epochs_run
        if self.tracer is not None:
            self.tracer.record(
                "fleet_epoch",
                epoch=epoch,
                peers=plan.num_peers,
                plan=plan.describe(),
            )
        reports: List[ExecutionReport] = []
        for rank, (a, times) in enumerate(
            zip(plan.assignments, per_peer_batch_s)
        ):
            if a.backend == "serverless":
                rep = self.serverless.simulate(
                    times,
                    model_bytes=model_bytes,
                    batch_bytes=batch_bytes,
                    epoch=epoch,
                    peer=rank,
                    memory_mb=a.memory_mb or None,
                )
            else:
                rep = self.instance_executor(a.instance).simulate_instance(
                    times,
                    model_bytes=model_bytes,
                    batch_bytes=batch_bytes,
                    epoch=epoch,
                    peer=rank,
                    reference_vcpus=self.instance_vcpus,
                )
            reports.append(rep)
        wall = max(r.wall_time_s for r in reports)
        for a, rep in zip(plan.assignments, reports):
            if a.backend == "instance":
                idle = wall - rep.wall_time_s
                if idle > 0.0:
                    rep.idle_s += idle
                    rep.instance_billed_s += idle
                    rep.cost_usd += ec2_cost_per_second(a.instance) * idle
        self.epochs_run += 1
        return FleetReport(
            plan=plan,
            epoch=epoch,
            per_peer=reports,
            wall_time_s=wall,
            total_usd=float(sum(r.cost_usd for r in reports)),
        )


def evaluate_candidates(
    candidates: Sequence[FleetPlan],
    per_peer_batch_s: Union[
        Sequence[Sequence[float]],
        Callable[[FleetPlan], Sequence[Sequence[float]]],
    ],
    *,
    model_bytes: int,
    batch_bytes: int,
    warm: bool = True,
    runtime: Union[RuntimeConfig, ServerlessRuntime, None] = None,
    instance_config: Optional[InstanceConfig] = None,
    instance_vcpus: float = 1.0,
    tracer: Any = None,
) -> List[CostReport]:
    """Measure every candidate plan — the scheduler's observation pass.

    Each candidate runs on a FRESH :class:`FleetExecutor` (no warm-pool or
    VM-state pollution between candidates). ``warm=True`` runs two epochs
    and reports the second — the steady state a multi-epoch training run
    lives in, with VM boots paid and containers warm — so a GPU peer's
    90 s boot doesn't disqualify it from a 60 s/epoch deadline it meets
    every epoch after the first. ``per_peer_batch_s`` is either one
    per-peer list-of-lists (every plan must have matching P) or a callable
    ``plan -> per-peer lists`` for candidates of varying P.
    """
    reports: List[CostReport] = []
    for plan in candidates:
        times = (
            per_peer_batch_s(plan)
            if callable(per_peer_batch_s)
            else per_peer_batch_s
        )
        fx = FleetExecutor(
            runtime=runtime,
            instance_config=instance_config,
            instance_vcpus=instance_vcpus,
            tracer=tracer,
        )
        fr = fx.run_epoch(
            plan, times, model_bytes=model_bytes, batch_bytes=batch_bytes
        )
        if warm:
            fr = fx.run_epoch(
                plan, times, model_bytes=model_bytes, batch_bytes=batch_bytes
            )
        reports.append(fr.cost_report())
    return reports


def standard_candidates(
    num_peers: int,
    *,
    memory_tiers: Sequence[int] = (0, 4400, LAMBDA_MAX_MEMORY_MB),
    cpu_tiers: Sequence[str] = ("t2.large", "t2.xlarge"),
    gpu_tiers: Sequence[str] = ("g4dn.xlarge", "p3.2xlarge"),
    mixed_gpu: str = "p3.2xlarge",
) -> List[FleetPlan]:
    """The default candidate set the trainer/CLI schedulers pick from:
    pure serverless at each memory tier (0 = planner auto), pure instance
    at each CPU/GPU tier, plus one half-GPU half-serverless mixed plan
    (ranks [0, P/2) on the GPU — pair them with the heavy workloads)."""
    cands = [
        FleetPlan.pure(
            "serverless",
            num_peers,
            memory_mb=m,
            name=f"serverless-{m or 'auto'}",
        )
        for m in memory_tiers
    ]
    for tier in list(cpu_tiers) + list(gpu_tiers):
        cands.append(
            FleetPlan.pure(
                "instance", num_peers, instance=tier, name=f"instance-{tier}"
            )
        )
    if num_peers >= 2:
        k = num_peers // 2
        mixed = tuple(
            PeerAssignment("instance", instance=mixed_gpu) for _ in range(k)
        ) + tuple(
            PeerAssignment("serverless") for _ in range(num_peers - k)
        )
        cands.append(FleetPlan(mixed, name=f"mixed-{k}x{mixed_gpu}"))
    return cands


# ---------------------------------------------------------------------------
# Scheduler registry — prescriptive frontier navigation
# ---------------------------------------------------------------------------


class Scheduler(abc.ABC):
    """Picks next epoch's plan from measured cost reports.

    ``choose`` sees one :class:`~repro_torch.core.cost.CostReport` per candidate
    (same order as the candidate list, e.g. from
    :func:`evaluate_candidates`) plus the operator's constraints, and
    returns the index of the plan to run. A deadline bounds the fleet
    epoch wall-clock (``wall_time_s``); a budget bounds the whole-cluster
    epoch cost (``total_usd``). Strict policies raise ``ValueError`` when
    no candidate is feasible — they never silently violate a constraint;
    ``pareto_walk`` is the best-effort alternative.
    """

    name: ClassVar[str] = "?"  # set by @register_scheduler

    @abc.abstractmethod
    def choose(
        self,
        reports: Sequence[CostReport],
        *,
        deadline_s: Optional[float] = None,
        budget_usd: Optional[float] = None,
    ) -> int:
        """Return the index of the candidate to run next epoch."""


_SCHED_REGISTRY: Dict[str, Type[Scheduler]] = {}


def register_scheduler(name: str):
    """Class decorator: make a scheduler reachable by name everywhere."""

    def deco(cls: Type[Scheduler]) -> Type[Scheduler]:
        if not issubclass(cls, Scheduler):
            raise TypeError(f"{cls!r} must subclass Scheduler")
        cls.name = name
        _SCHED_REGISTRY[name] = cls
        return cls

    return deco


def available_schedulers() -> Tuple[str, ...]:
    return tuple(sorted(_SCHED_REGISTRY))


def get_scheduler(name: str, **kwargs) -> Scheduler:
    try:
        cls = _SCHED_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; registered schedulers: "
            f"{', '.join(available_schedulers())}"
        )
    return cls(**kwargs)


@register_scheduler("cheapest_under_deadline")
class CheapestUnderDeadline(Scheduler):
    """Minimum whole-cluster cost among plans meeting the wall-clock
    deadline. With no deadline, simply the cheapest plan. Raises when no
    candidate is fast enough — the caller must relax the deadline or add
    candidates, never overshoot silently."""

    def choose(self, reports, *, deadline_s=None, budget_usd=None):
        feasible = [
            i
            for i, r in enumerate(reports)
            if deadline_s is None or r.wall_time_s <= deadline_s
        ]
        if not feasible:
            fastest = min(r.wall_time_s for r in reports)
            raise ValueError(
                f"no candidate meets the {deadline_s:.3g}s deadline; the "
                f"fastest plan takes {fastest:.3g}s"
            )
        return min(
            feasible,
            key=lambda i: (reports[i].total_usd, reports[i].wall_time_s, i),
        )


@register_scheduler("fastest_under_budget")
class FastestUnderBudget(Scheduler):
    """Minimum epoch wall-clock among plans within the whole-cluster
    budget. With no budget, simply the fastest plan. Raises when every
    candidate overspends."""

    def choose(self, reports, *, deadline_s=None, budget_usd=None):
        feasible = [
            i
            for i, r in enumerate(reports)
            if budget_usd is None or r.total_usd <= budget_usd
        ]
        if not feasible:
            cheapest = min(r.total_usd for r in reports)
            raise ValueError(
                f"no candidate fits the ${budget_usd:.3g} epoch budget; the "
                f"cheapest plan costs ${cheapest:.3g}"
            )
        return min(
            feasible,
            key=lambda i: (reports[i].wall_time_s, reports[i].total_usd, i),
        )


@register_scheduler("pareto_walk")
class ParetoWalk(Scheduler):
    """Greedy best-effort frontier walk.

    Starts at the cheapest point of the measured Pareto frontier and steps
    toward faster/costlier frontier points only while the deadline is
    still violated and the next step stays within budget. Never picks a
    dominated plan and never raises: infeasible constraints yield the
    closest frontier point (the fastest affordable one when no point meets
    the deadline; the cheapest one when everything overspends)."""

    def choose(self, reports, *, deadline_s=None, budget_usd=None):
        front = pareto_frontier(reports)
        # frontier is wall-ascending == cost-descending; walk cheapest-first
        order = [reports.index(p) for p in reversed(front)]
        pick = order[0]
        for nxt in order[1:]:
            if deadline_s is None or reports[pick].wall_time_s <= deadline_s:
                break  # deadline met (or absent): stop, this is cheapest
            if (
                budget_usd is not None
                and reports[nxt].total_usd > budget_usd
            ):
                break  # the faster step would overspend: best effort stops
            pick = nxt
        return pick
