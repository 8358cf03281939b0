"""Quickstart: the paper's system in ~60 lines, on the card.

Four peers train MobileNetV3-Small on MNIST-shaped data with Algorithm 1 —
per-peer partitions, per-batch gradients offloaded to the serverless
executor (which times each batch with the device synchronised and prices
the Lambda fan-out), RabbitMQ-style mailbox exchange, convergence
detection — then we print the Table-I-style stage breakdown and the cost
of both backends. The Lambda wall time and dollars are simulated
accounting over the measured batch times, not a measurement of Lambda.

    PYTHONPATH=src python -m repro_torch.examples.quickstart               # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu --epochs 1
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core import (
    InstanceConfig,
    LocalP2PCluster,
    RuntimeConfig,
    ServerlessExecutor,
    compare_backends,
)
from repro_torch.data import make_dataset
from repro_torch.optim import sgd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args(argv)

    dataset = make_dataset("mnist", size=512, image_hw=12, channels=1)
    cluster = LocalP2PCluster(
        get_config("mobilenet-v3-small"),
        dataset,
        num_peers=4,
        batch_size=16,
        batches_per_epoch=2,
        optimizer=sgd(momentum=0.9),
        lr=0.05,
        sync=True,  # RabbitMQ barrier semantics
        exchange="allgather_mean",  # any name in repro_torch.core.available_exchanges()
        graph="ring",  # peer overlay: full | ring | gossip:K | hierarchical
        executor=ServerlessExecutor(  # Lambda fan-out on the event engine
            backend="serverless",
            runtime=RuntimeConfig.aws_default(),  # cold starts, rare faults
            allocation="latency",  # dynamic per-epoch memory sizing
        ),
        device=args.device,
    )
    print(f"overlay: {cluster.graph.describe()}")
    print(f"exchange={cluster.protocol.name}: {cluster.comm_cost().summary()}")
    history = cluster.run(epochs=args.epochs)

    print("\n=== training history ===")
    for h in history:
        print(
            f"epoch {h['epoch']}: loss={h['loss']:.3f} "
            f"val_acc={h.get('val_acc', float('nan')):.3f}"
        )

    print("\n=== Table-I-style stage breakdown (peer 0) ===")
    for stage, row in cluster.peers[0].metrics.table().items():
        print(f"{stage:24s} time={row['time_s']:.3f}s cpu={row['cpu_percent']:.0f}% "
              f"mem={row['memory_mb']:.0f}MB")

    for rep in cluster.peers[0].reports:
        print(
            f"\nepoch {rep.epoch} serverless execution (simulated accounting of the "
            f"measured batch times): {rep.num_batches} lambdas x "
            f"{rep.lambda_memory_mb}MB, wall {rep.wall_time_s:.2f}s "
            f"(sequential compute was {rep.measured_compute_s:.2f}s), "
            f"cold_starts={rep.num_cold_starts} retries={rep.num_retries} "
            f"cost ${rep.cost_usd:.6f}/peer/epoch"
        )

    # The paper's headline, for THIS workload: price the last measured epoch
    # under the instance baseline too (t2.large; ideal config — a steady-state
    # VM with its one-off boot long amortized) and compare.
    srep = cluster.peers[0].reports[-1]
    irep = ServerlessExecutor(
        backend="instance", instance="t2.large",
        instance_config=InstanceConfig.ideal(),
    ).simulate_instance(srep.per_batch_s)
    cmp = compare_backends(srep.cost_report(), irep.cost_report())
    rel = "faster" if cmp["speedup_pct"] >= 0 else "slower"
    print(
        f"\nserverless vs instance (t2.large): {abs(cmp['speedup_pct']):.1f}% "
        f"{rel} at {cmp['cost_multiple']:.2f}x the cost "
        f"(${cmp['serverless_usd']:.6f} vs ${cmp['instance_usd']:.6f} "
        f"per peer-epoch) — the fan-out wins as batches/peer grow "
        f"(paper, 235 batches: 97.34% faster at up to 5.4x)"
    )


if __name__ == "__main__":
    main()
