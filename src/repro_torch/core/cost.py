"""Cost model — reproduces the paper's Tables II/III.

A copy of the reference's ``repro/core/cost.py``, price tables included.

AWS backend (paper-faithful):
  * Lambda (ARM, the paper packages for "our custom ARM architecture"):
    $0.0000133334 per GB-second. With this constant the paper's per-second
    Lambda costs reproduce exactly: 4400 MB -> $0.0000573/s, 2800 MB ->
    $0.0000362/s, 1800 MB -> $0.0000233/s, 1700 MB -> $0.0000220/s.
  * EC2 on-demand: t2.small $0.023/h ($0.00000639/s, paper Table II),
    t2.medium $0.0464/h, t2.large $0.0928/h ($0.00002578/s, paper Table III).

  Formula (1):  cost_serverless = (lambda_cost_s * num_batches + ec2_cost_s) * T
  Formula (2):  cost_instance  = ec2_cost_s * T

``TPUCost`` keeps the reference's chip-second price table so that the
two packages price alike; it is a price, not a timing of any device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

LAMBDA_USD_PER_GB_S_ARM = 0.0000133334
LAMBDA_USD_PER_REQUEST = 0.20 / 1_000_000

EC2_USD_PER_HOUR = {
    "t2.nano": 0.0058,
    "t2.micro": 0.0116,
    "t2.small": 0.023,
    "t2.medium": 0.0464,
    "t2.large": 0.0928,
    "t2.xlarge": 0.1856,
}

# t2 tier shapes (AWS docs): what the instance-baseline simulation sizes
# against — memory bounds the resident model + batch working set (the
# paper's "resource-constrained scenario" forces mini-batch splitting when
# it doesn't fit), vCPUs scale sequential gradient compute.
EC2_MEMORY_MB = {
    "t2.nano": 512,
    "t2.micro": 1024,
    "t2.small": 2048,
    "t2.medium": 4096,
    "t2.large": 8192,
    "t2.xlarge": 16384,
}

EC2_VCPUS = {
    "t2.nano": 1,
    "t2.micro": 1,
    "t2.small": 1,
    "t2.medium": 2,
    "t2.large": 2,
    "t2.xlarge": 4,
}

# ---------------------------------------------------------------------------
# GPU instance tiers (heterogeneous-fleet extension)
# ---------------------------------------------------------------------------
# The 2025 follow-up ("Cost-Performance Analysis: CPU-Based Serverless vs
# GPU-Based Training Architectures") argues the real decision space is
# CPU-serverless vs GPU instances vs mixed fleets. These are single-GPU AWS
# on-demand tiers (us-east-1 list prices at paper time): per-hour price,
# device (HBM) memory bounding the resident working set, wall-clock speedup
# of one training epoch vs the 1-vCPU CPU reference the per-batch times are
# measured on (compute-bound training), and provisioning/boot time (AMI
# pull + driver/CUDA init — materially slower than a t2 boot).

GPU_USD_PER_HOUR = {
    "g4dn.xlarge": 0.526,  # 1x T4 (16 GB)
    "g5.xlarge": 1.006,  # 1x A10G (24 GB)
    "p3.2xlarge": 3.06,  # 1x V100 (16 GB)
}

GPU_MEMORY_MB = {
    "g4dn.xlarge": 16_384,
    "g5.xlarge": 24_576,
    "p3.2xlarge": 16_384,
}

# Epoch-compute speedup vs the 1-vCPU reference machine (the same baseline
# `EC2_VCPUS` scales against), i.e. "equivalent vCPUs" of the device on
# this workload class. Conservative mid-size-CNN figures.
GPU_SPEEDUP = {
    "g4dn.xlarge": 8.0,
    "g5.xlarge": 16.0,
    "p3.2xlarge": 24.0,
}

GPU_BOOT_S = {
    "g4dn.xlarge": 60.0,
    "g5.xlarge": 60.0,
    "p3.2xlarge": 90.0,
}

# Unified tier views: every InstanceRuntime surface (pricing, memory fit,
# compute scaling) resolves tiers through these, so GPU and CPU instances
# ride the same billing/boot/churn machinery.
INSTANCE_USD_PER_HOUR = {**EC2_USD_PER_HOUR, **GPU_USD_PER_HOUR}
INSTANCE_MEMORY_MB = {**EC2_MEMORY_MB, **GPU_MEMORY_MB}


def is_gpu_instance(instance: str) -> bool:
    return instance in GPU_USD_PER_HOUR


def instance_equivalent_vcpus(instance: str) -> float:
    """Compute speed of a tier in 1-vCPU-reference units: vCPU count for
    CPU tiers, the measured epoch speedup for GPU tiers."""
    if instance in GPU_SPEEDUP:
        return GPU_SPEEDUP[instance]
    return float(EC2_VCPUS[instance])


TPU_V5E_USD_PER_CHIP_HOUR = 1.20


def working_set_mb(
    model_bytes: int, batch_bytes: int, overhead_mb: float = 0.0
) -> float:
    """Resident working set of one training step, in MB: params + grads
    (2x model) + activations (~3x one batch) + runtime overhead. The ONE
    sizing model shared by ``ServerlessPlanner.lambda_memory_mb`` (Lambda
    tier fit) and ``repro_torch.core.instance.instance_splits`` (EC2
    mini-batch splitting), so the two backends' memory stories cannot
    drift apart."""
    return (2 * model_bytes + 3 * batch_bytes) / 1e6 + overhead_mb


def ec2_cost_per_second(instance: str) -> float:
    """Per-second on-demand price of any instance tier — CPU (t2.*) or GPU
    (g4dn/g5/p3) — so :class:`InstanceCost` prices GPU fleets unchanged."""
    return INSTANCE_USD_PER_HOUR[instance] / 3600.0


def lambda_cost_per_second(memory_mb: int) -> float:
    return (memory_mb / 1024.0) * LAMBDA_USD_PER_GB_S_ARM


@dataclass(frozen=True)
class ServerlessCost:
    """Paper formula (1) plus full invocation billing.

    Beyond the paper's ``(lambda_s * m + ec2_s) * T``, the runtime engine
    threads through what real Lambda bills: the per-request fee for every
    invocation *including retries*, the GB-seconds burned by failed
    attempts that re-executed, and cold-start init time.
    """

    compute_time_s: float
    num_batches: int
    lambda_memory_mb: int
    instance: str = "t2.small"
    include_request_fee: bool = True  # bill every invocation, like AWS does
    num_retries: int = 0  # re-invocations after failures/timeouts
    retry_billed_s: float = 0.0  # Lambda seconds burned by failed attempts
    cold_start_billed_s: float = 0.0  # container init time billed as GB-s
    # degree-aware exchange egress: bytes the peer moved on the overlay
    # this epoch (per-edge payload x degree, from the exchange accounting)
    egress_bytes: int = 0
    usd_per_gb_egress: float = 0.0

    @property
    def lambda_cost_s(self) -> float:
        return lambda_cost_per_second(self.lambda_memory_mb)

    @property
    def request_fee_usd(self) -> float:
        if not self.include_request_fee:
            return 0.0
        return LAMBDA_USD_PER_REQUEST * (self.num_batches + self.num_retries)

    @property
    def egress_usd(self) -> float:
        return self.egress_bytes / 1e9 * self.usd_per_gb_egress

    @property
    def cost_per_peer(self) -> float:
        """Formula (1) + retries + cold-start GB-s + request fees + egress."""
        c = (
            self.lambda_cost_s * self.num_batches
            + ec2_cost_per_second(self.instance)
        ) * self.compute_time_s
        c += self.lambda_cost_s * (self.retry_billed_s + self.cold_start_billed_s)
        return c + self.request_fee_usd + self.egress_usd


@dataclass(frozen=True)
class InstanceCost:
    """Paper formula (2) plus full per-second EC2 billing.

    The analytic form — ``ec2_cost_s * T`` with every engine field at its
    zero default — is exactly the paper's Formula (2). The engine-priced
    variant (:class:`repro_torch.core.instance.InstanceRuntime`) additionally
    bills what a real VM fleet bills: boot/provisioning time (the meter
    runs while the stack starts) and idle time (e.g. waiting at the sync
    barrier for slower peers), while churn ``unbilled_downtime_s`` — the
    gap between a VM dying and its replacement starting to boot — extends
    the wall-clock without extending the bill.
    """

    compute_time_s: float  # busy seconds: batches + churn redos + wire time
    instance: str = "t2.large"
    boot_s: float = 0.0  # provisioning/boot seconds (billed)
    idle_s: float = 0.0  # billed-but-idle seconds (barrier wait)
    unbilled_downtime_s: float = 0.0  # churn gaps with no VM running

    @property
    def billed_s(self) -> float:
        return self.compute_time_s + self.boot_s + self.idle_s

    @property
    def wall_time_s(self) -> float:
        return self.billed_s + self.unbilled_downtime_s

    @property
    def cost_per_peer(self) -> float:
        """Paper formula (2); boot/idle extend T, downtime never does."""
        return ec2_cost_per_second(self.instance) * self.billed_s


@dataclass(frozen=True)
class CommCost:
    """Per-step gradient-exchange wire cost of one peer.

    ``wire_bytes_per_step`` comes straight from the active
    :class:`~repro_torch.core.exchange.ExchangeProtocol`'s byte accounting
    (``protocol.wire_bytes`` / ``P2PTrainer.comm_cost`` /
    ``LocalP2PCluster.comm_cost``), so compression and sparsification show
    up in wire seconds and egress dollars without re-deriving sizes.

    Degree-aware since the PeerGraph redesign: ``bytes_per_edge`` is the
    payload on one overlay edge and ``degree`` the peer's neighbor count,
    so sparse topologies (ring: 2, gossip: k) read O(degree) per peer
    while the full mesh reads O(P). ``bytes_per_edge=0`` marks a fused
    collective (e.g. psum_mean) whose traffic doesn't decompose into
    edges — ``wire_bytes_per_step`` is then the only authoritative figure.
    """

    wire_bytes_per_step: int
    bandwidth_bps: float = 1e9  # the paper's simulated inter-peer link
    usd_per_gb_egress: float = 0.0  # e.g. S3 / inter-AZ transfer pricing
    bytes_per_edge: int = 0  # payload per overlay edge; 0 = fused/unknown
    degree: float = 0.0  # mean neighbor count under the overlay graph
    graph_name: str = "full"
    # Sharded exchange (reduce_scatter): the per-edge payload is ONE shard
    # of the flattened gradient buffer — model/P bytes — so it shrinks as
    # 1/P while dense protocols stay flat. num_shards=1 marks unsharded.
    num_shards: int = 1
    shard_bytes: int = 0  # one shard's wire payload; 0 = unsharded

    @property
    def seconds_per_step(self) -> float:
        return self.wire_bytes_per_step * 8.0 / self.bandwidth_bps

    @property
    def usd_per_step(self) -> float:
        return self.wire_bytes_per_step / 1e9 * self.usd_per_gb_egress

    def summary(self) -> str:
        s = (
            f"{self.wire_bytes_per_step/1e6:.2f} MB/peer/step on the wire "
            f"({self.seconds_per_step*1e3:.1f} ms at "
            f"{self.bandwidth_bps/1e9:g} Gb/s)"
        )
        if self.bytes_per_edge:
            s += (
                f" [{self.graph_name} graph: {self.bytes_per_edge/1e6:.2f} MB"
                f"/edge x degree {self.degree:g}]"
            )
        if self.num_shards > 1:
            s += (
                f" [sharded: {self.num_shards} shards x "
                f"{self.shard_bytes/1e6:.2f} MB]"
            )
        return s


@dataclass(frozen=True)
class TPUCost:
    """Beyond-paper: the same trade-off expressed in chip-seconds."""

    step_time_s: float
    chips: int
    usd_per_chip_hour: float = TPU_V5E_USD_PER_CHIP_HOUR

    @property
    def cost_per_step(self) -> float:
        return self.step_time_s * self.chips * self.usd_per_chip_hour / 3600.0


# ---------------------------------------------------------------------------
# CostReport — the unified cost–time frontier API
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CostReport:
    """One backend's (wall-clock, dollars) point for one peer-epoch.

    The common currency between :class:`ServerlessCost` and the
    engine-priced :class:`InstanceCost`: both execution paths reduce their
    accounting to a ``CostReport`` (``ExecutionReport.cost_report()``), so
    the paper's headline comparison — serverless up to 97.34% faster at up
    to 5.4x the cost — is a pair of these and two method calls.
    """

    backend: str  # "serverless" | "instance" | "fleet" (heterogeneous mix)
    wall_time_s: float
    cost_usd: float  # per peer per epoch
    instance: str = ""  # EC2 tier (baseline VM or serverless orchestrator)
    lambda_memory_mb: int = 0  # serverless only
    num_peers: int = 1
    label: str = ""  # free-form scenario tag for frontier plots

    @property
    def total_usd(self) -> float:
        """Whole-cluster epoch cost (every peer pays its own bill)."""
        return self.cost_usd * self.num_peers

    def speedup_pct_vs(self, baseline: "CostReport") -> float:
        """Wall-clock improvement over ``baseline``, in percent (the
        paper's 97.34% figure is ``serverless.speedup_pct_vs(instance)``)."""
        if baseline.wall_time_s <= 0.0:
            return 0.0
        return 100.0 * (1.0 - self.wall_time_s / baseline.wall_time_s)

    def cost_multiple_vs(self, baseline: "CostReport") -> float:
        """Dollar multiple over ``baseline`` (the paper's 5.4x figure)."""
        if baseline.cost_usd <= 0.0:
            return float("inf") if self.cost_usd > 0 else 1.0
        return self.cost_usd / baseline.cost_usd

    def summary(self) -> str:
        s = f"{self.backend}: wall {self.wall_time_s:.2f}s ${self.cost_usd:.6f}/peer/epoch"
        if self.lambda_memory_mb:
            s += f" ({self.lambda_memory_mb}MB Lambda)"
        if self.instance:
            s += f" [{self.instance}]"
        return s


def compare_backends(
    serverless: CostReport,
    instance: CostReport,
    fleet: Optional[CostReport] = None,
) -> Dict[str, float]:
    """The paper's headline comparison as one dict: speedup % and cost
    multiple of the serverless point over the instance baseline, plus the
    raw coordinates of both points (handy for JSON benchmark records).

    ``fleet`` mode: pass a third (heterogeneous-fleet) point and the dict
    additionally carries its coordinates and its speedup/cost-multiple
    over the same instance baseline — the three-way comparison the
    auto-scheduler navigates (fig14)."""
    out = {
        "speedup_pct": serverless.speedup_pct_vs(instance),
        "cost_multiple": serverless.cost_multiple_vs(instance),
        "serverless_wall_s": serverless.wall_time_s,
        "instance_wall_s": instance.wall_time_s,
        "serverless_usd": serverless.cost_usd,
        "instance_usd": instance.cost_usd,
    }
    if fleet is not None:
        out.update({
            "fleet_wall_s": fleet.wall_time_s,
            "fleet_usd": fleet.cost_usd,
            "fleet_speedup_pct": fleet.speedup_pct_vs(instance),
            "fleet_cost_multiple": fleet.cost_multiple_vs(instance),
        })
    return out


def dominates(a: CostReport, b: CostReport) -> bool:
    """True iff ``a`` Pareto-dominates ``b``: at least as fast AND at
    least as cheap, strictly better in at least one coordinate. Two points
    with identical coordinates never dominate each other."""
    return (
        a.wall_time_s <= b.wall_time_s
        and a.cost_usd <= b.cost_usd
        and (a.wall_time_s < b.wall_time_s or a.cost_usd < b.cost_usd)
    )


def _frontier_key(p: CostReport):
    # A TOTAL order over CostReports: (wall, cost) first, then every
    # identity field as a deterministic tie-break — so equal-coordinate
    # points sort the same way under any input permutation and the
    # frontier's membership/order never depends on arrival order.
    return (
        p.wall_time_s, p.cost_usd,
        p.backend, p.instance, p.label, p.lambda_memory_mb, p.num_peers,
    )


def pareto_frontier(points: Sequence[CostReport]) -> List[CostReport]:
    """The non-dominated subset of (wall_time_s, cost_usd) points, sorted
    by wall-clock ascending — the cost–time frontier a deployment actually
    chooses from. A point survives iff no other point is at least as fast
    AND at least as cheap (strictly better in one coordinate).

    Coordinate ties are kept, not evicted: two reports with equal wall AND
    equal cost do not dominate each other, so both stay on the frontier
    (previously the later-sorted one was silently dropped, which made the
    frontier's membership depend on input order)."""
    pts = sorted(points, key=_frontier_key)
    frontier: List[CostReport] = []
    best_cost = float("inf")
    best_wall = float("inf")
    for p in pts:
        if p.cost_usd < best_cost:
            frontier.append(p)
            best_cost = p.cost_usd
            best_wall = p.wall_time_s
        # intentionally EXACT: only bit-identical coordinates are mutual
        # non-domination ties; approximate ties are real dominations
        elif p.cost_usd == best_cost and p.wall_time_s == best_wall:  # noqa: RA006
            # exact coordinate tie with the last frontier point: mutually
            # non-dominated, keep both
            frontier.append(p)
    return frontier


def paper_table2_row(batch_size: int) -> Dict[str, float]:
    """The paper's measured Table II inputs, for validation tests."""
    rows = {
        1024: dict(num_batches=15, lambda_memory_mb=4400, compute_time_s=41.2),
        512: dict(num_batches=30, lambda_memory_mb=2800, compute_time_s=28.1),
        128: dict(num_batches=118, lambda_memory_mb=1800, compute_time_s=12.9),
        64: dict(num_batches=235, lambda_memory_mb=1700, compute_time_s=10.5),
    }
    return rows[batch_size]


def paper_table3_row(batch_size: int) -> Dict[str, float]:
    rows = {
        1024: dict(compute_time_s=258.0),
        512: dict(compute_time_s=278.4),
        128: dict(compute_time_s=330.4),
        64: dict(compute_time_s=394.8),
    }
    return rows[batch_size]
