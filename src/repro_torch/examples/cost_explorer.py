"""Cost explorer: when is serverless P2P worth it?

Sweeps the paper's trade-off space — batch size, number of Lambda
invocations, memory sizing — and prints the serverless-vs-instance cost and
time Pareto, using the unified CostReport frontier API throughout: the
paper's own Table II/III points and the engine-priced instance baseline
(boot, idle billing, memory-constrained splitting). Pure accounting: it
runs no model and touches no device. The twin of the reference's
``examples/cost_explorer.py`` without its TPU chip-second section.

    PYTHONPATH=src python -m repro_torch.examples.cost_explorer
"""
import torch

from repro_torch.core.cost import (
    CommCost,
    CostReport,
    InstanceCost,
    ServerlessCost,
    compare_backends,
    pareto_frontier,
    paper_table2_row,
    paper_table3_row,
)
from repro_torch.core.events import InstanceConfig, RuntimeConfig, available_allocations
from repro_torch.core.exchange import ExchangeContext, available_exchanges, get_exchange
from repro_torch.core.serverless import ServerlessExecutor, ServerlessPlanner


def main():
    print("=== Paper Tables II/III (VGG11 / MNIST / 4 peers), via CostReport ===")
    print(f"{'batch':>6} {'serverless $':>13} {'instance $':>11} {'multiple':>8} "
          f"{'t_serverless':>12} {'t_instance':>11} {'speedup':>8}")
    for b in (1024, 512, 128, 64):
        r2, r3 = paper_table2_row(b), paper_table3_row(b)
        s = CostReport(
            "serverless", r2["compute_time_s"],
            ServerlessCost(r2["compute_time_s"], r2["num_batches"],
                           r2["lambda_memory_mb"], "t2.small").cost_per_peer,
            label=f"batch{b}",
        )
        i = CostReport(
            "instance", r3["compute_time_s"],
            InstanceCost(r3["compute_time_s"], "t2.large").cost_per_peer,
            instance="t2.large", label=f"batch{b}",
        )
        cmp = compare_backends(s, i)
        print(f"{b:>6} {s.cost_usd:>13.5f} {i.cost_usd:>11.5f} "
              f"{cmp['cost_multiple']:>7.2f}x "
              f"{s.wall_time_s:>11.1f}s {i.wall_time_s:>10.1f}s "
              f"{cmp['speedup_pct']:>7.1f}%")

    print("\n=== Planner: Lambda sizing vs model size (batch 4 MB) ===")
    planner = ServerlessPlanner()
    for mb in (5, 50, 500, 2000, 4000):
        mem = planner.lambda_memory_mb(int(mb * 1e6), int(4e6))
        print(f"model {mb:>5} MB  ->  lambda {mem:>6} MB "
              f"({mem/1769:.2f} vCPU)")

    print("\n=== Exchange wire cost: VGG11-sized gradient, 4 peers, 1 Gb/s ===")
    # shapes only: a tensor on the meta device has no storage, so byte
    # accounting never materializes the gradient
    grads_like = {"vgg11": torch.empty((132_863_336,), dtype=torch.float32, device="meta")}
    ctx = ExchangeContext(num_peers=4, topk_frac=0.01)
    for name in available_exchanges():
        cc = CommCost(
            wire_bytes_per_step=get_exchange(name).wire_bytes(grads_like, ctx),
            bandwidth_bps=1e9, usd_per_gb_egress=0.09,  # AWS inter-AZ-ish
        )
        print(f"{name:16s} {cc.wire_bytes_per_step/1e6:>8.1f} MB/step "
              f"{cc.seconds_per_step:>7.2f} s/step  ${cc.usd_per_step:.4f}/step egress")

    print("\n=== Runtime engine: faults, cold starts, allocation policies ===")
    # 30 one-second batches on a 50 MB model, 4 epochs per scenario
    per_batch = [1.0 + 0.02 * i for i in range(30)]
    for label, runtime, alloc in (
        ("ideal / static", RuntimeConfig(), "static"),
        ("aws / static", RuntimeConfig.aws_default(), "static"),
        ("aws / latency", RuntimeConfig.aws_default(), "latency"),
    ):
        ex = ServerlessExecutor(runtime=runtime, allocation=alloc)
        rep = None
        for epoch in range(4):
            rep = ex.simulate(per_batch, model_bytes=int(50e6),
                              batch_bytes=int(4e6), epoch=epoch)
        print(f"{label:16s} epoch3: {rep.lambda_memory_mb:>5}MB "
              f"wall={rep.wall_time_s:6.2f}s cold={rep.num_cold_starts} "
              f"retries={rep.num_retries} ${rep.cost_usd:.6f}/peer/epoch")
    print(f"(allocation policies registered: {', '.join(available_allocations())})")

    print("\n=== Engine-priced instance baseline + the cost-time frontier ===")
    # the same 30 batches, sequentially, across EC2 tiers (boot 40 s billed;
    # a VGG11-scale model + large batch splits on the small tier)
    model_bytes, batch_bytes = int(531e6), int(160e6)
    sex = ServerlessExecutor(instance="t2.small", instance_vcpus=1.0)
    srep = sex.simulate(per_batch, model_bytes=model_bytes,
                        batch_bytes=batch_bytes)
    points = [srep.cost_report(label="serverless")]
    for tier in ("t2.small", "t2.medium", "t2.large"):
        iex = ServerlessExecutor(
            backend="instance", instance=tier,
            instance_config=InstanceConfig(boot_s=40.0),
        )
        irep = iex.simulate_instance(
            per_batch, model_bytes=model_bytes, batch_bytes=batch_bytes,
            reference_vcpus=1.0,
        )
        points.append(irep.cost_report(label=tier))
        cmp = compare_backends(points[0], points[-1])
        print(f"{tier:10s} wall={irep.wall_time_s:7.2f}s "
              f"(boot={irep.boot_s:.0f}s splits={irep.num_splits}) "
              f"${irep.cost_usd:.6f}  ->  serverless "
              f"{cmp['speedup_pct']:.2f}% faster at "
              f"{cmp['cost_multiple']:.2f}x the cost")
    print("frontier (non-dominated wall/cost points):")
    for p in pareto_frontier(points):
        print(f"  {p.label:12s} {p.summary()}")


if __name__ == "__main__":
    main()
