"""Training driver of the port, a twin of the reference's
``repro/launch/train.py``: the same flags and printed lines.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --steps 20 --batch 8 --seq 64 --exchange allgather_mean
    PYTHONPATH=src python -m repro_torch.launch.train --full --arch qwen2.5-3b \\
        --data-parallel 2 --batch 2 --seq 2048 --steps 4     # on the card

``--arch`` takes the LMs of the port's registry (``configs.LM_ARCHS``:
the Mamba-2, dense, hybrid and MoE LMs, a MoE layer taking the dense
dispatch, the reference trainer's default; internvl2 on text alone).
Like the reference's CLI it builds token-only batches, so whisper-base,
whose batches need frames, trains through ``train.build_train_step``
instead. Where they differ:

* ``--data-parallel N`` is the peer count P (default 1, what the reference
  gets on one device): the P peers are a stacked dimension on one card.
  ``--batch`` is the global batch, P x b rows; peer r takes rows
  [r b, (r + 1) b).
* ``--model-parallel M`` is the Lambda slots of each peer, the reference's
  "model" mesh axis: it sets only the printed mesh
  (``launch.mesh.make_host_mesh``). The reference's slots each take a part
  of a peer's batch and reduce their gradients, which is the gradient of
  the peer's whole batch; on one card the slots are stacked in that batch,
  so M changes no number.
* ``--device`` (default ``cuda``; ``cpu`` runs the plain versions).
* ``--qsgd-impl`` and ``--topk-impl`` are accepted and change nothing: the
  tensor's device picks the implementation, the CUDA kernels on the card
  and their plain versions on the CPU.
* The ``ce`` printed is peer 0's (ROADMAP.md, reference behaviour 21): the
  port's step returns each peer's ``aux`` as a ``(P,)`` tensor, and the
  reference prints its replicated ``out_specs`` value, which reads as mesh
  device 0's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.compression import QSGDConfig
from repro_torch.core.convergence import ConvergenceDetector
from repro_torch.core.cost import INSTANCE_MEMORY_MB
from repro_torch.core.events import InstanceConfig, RuntimeConfig, available_allocations
from repro_torch.core.exchange import available_exchanges, get_exchange
from repro_torch.core.p2p import Topology
from repro_torch.core.robust import ATTACK_KINDS, AdversarySpec
from repro_torch.core.scheduler import available_schedulers
from repro_torch.data import BatchKey, DataLoader, Partitioner, make_dataset
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import _sync
from repro_torch.optim import adam, sgd
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import P2PTrainer

_IMPL_HELP = ("accepted for the reference's command lines; the tensor's device picks the "
              "implementation: the CUDA kernels on the card, their plain versions on the CPU")


def make_lm_batch(loader: DataLoader, key: BatchKey, vocab: int):
    """The loader's (P b, S) rows as int64 tensors; peer r takes rows
    [r b, (r + 1) b)."""
    b = loader.load(key)
    return {
        "tokens": torch.from_numpy(b["tokens"] % vocab).long(),
        "labels": torch.from_numpy(b["labels"] % vocab).long(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    ap.add_argument("--exchange", default="allgather_mean",
                    help="exchange protocol, optionally parameterized "
                         "NAME[:ARG] (e.g. trimmed_mean:0.25, krum:2); "
                         f"names: {', '.join(available_exchanges())}")
    ap.add_argument("--graph", default="full",
                    help="peer overlay graph: full | ring | gossip:K | "
                         "hierarchical[:GROUP] (see repro_torch.core.graph)")
    ap.add_argument("--graph-seed", type=int, default=0,
                    help="seed for stochastic overlays (gossip)")
    ap.add_argument("--staleness", type=int, default=1,
                    help="async: consume banks published K steps ago")
    ap.add_argument("--topk-frac", type=float, default=0.01,
                    help="topk: fraction of gradient entries shipped")
    ap.add_argument("--topk-impl", default="jnp", choices=["jnp", "kernel"], help=_IMPL_HELP)
    ap.add_argument("--qsgd-impl", default="jnp", choices=["jnp", "kernel"], help=_IMPL_HELP)
    ap.add_argument("--qsgd-levels", type=int, default=127,
                    help="qsgd quantization levels s (int8 range; 3 = the "
                         "aggressive setting EF keeps convergent)")
    ap.add_argument("--ef", action="store_true",
                    help="EF-SGD error feedback: accumulate the compression "
                         "residual per peer and re-inject it next step "
                         "(keeps qsgd/topk convergent at aggressive settings)")
    # robust aggregation + adversary model (repro_torch.core.robust)
    ap.add_argument("--trim-frac", type=float, default=0.0,
                    help="trimmed_mean: fraction trimmed from EACH end "
                         "(spec param trimmed_mean:F overrides)")
    ap.add_argument("--krum-m", type=int, default=1,
                    help="krum: multi-Krum m, averages the m lowest-scored "
                         "peers (spec param krum:M overrides)")
    ap.add_argument("--robust-clip", type=float, default=0.0,
                    help="robust protocols: clip each peer's contribution "
                         "to this global norm before aggregation (0 = off)")
    ap.add_argument("--adversary-frac", type=float, default=0.0,
                    help="fraction of peers that publish poisoned gradients")
    ap.add_argument("--adversary-num", type=int, default=None,
                    help="exact Byzantine peer count (overrides --adversary-frac)")
    ap.add_argument("--attack", default="sign_flip", choices=list(ATTACK_KINDS),
                    help="poison applied by Byzantine peers (stale_replay is "
                         "host-cluster only)")
    ap.add_argument("--adversary-scale", type=float, default=10.0,
                    help="attack magnitude (sign-flip multiplier / noise std)")
    ap.add_argument("--adversary-seed", type=int, default=0,
                    help="seed selecting WHICH peers are Byzantine")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="peers P, a stacked dimension on the one card")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="Lambda slots per peer (the mesh's model axis), stacked on the one card")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--restore", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    # serverless runtime model (ServerlessRuntime event engine)
    ap.add_argument("--runtime-preset", default="ideal", choices=["ideal", "aws"],
                    help="base fault/cold-start model for serverless accounting")
    ap.add_argument("--failure-rate", type=float, default=None,
                    help="override: P(invocation attempt fails)")
    ap.add_argument("--cold-start-s", type=float, default=None,
                    help="override: container init seconds on a cold start")
    ap.add_argument("--concurrency", type=int, default=None,
                    help="override: Lambda concurrency cap (0 = unbounded)")
    ap.add_argument("--straggler-prob", type=float, default=None,
                    help="override: P(invocation draws a tail latency)")
    ap.add_argument("--allocation", default="static",
                    choices=list(available_allocations()),
                    help="per-epoch Lambda memory sizing policy")
    ap.add_argument("--serverless-report", action="store_true",
                    help="account measured step times under the runtime at exit")
    # instance-baseline model (InstanceRuntime event engine)
    ap.add_argument("--backend", default="serverless",
                    choices=["serverless", "instance"],
                    help="which accounting model prices the measured steps")
    ap.add_argument("--instance-type", default="t2.large",
                    choices=sorted(INSTANCE_MEMORY_MB),
                    help="instance tier of the baseline: CPU (t2.*) or "
                         "GPU (g4dn/g5/p3)")
    ap.add_argument("--boot-s", type=float, default=None,
                    help="instance: VM provision+boot seconds (billed)")
    ap.add_argument("--instance-churn-prob", type=float, default=None,
                    help="instance: P(the VM dies while computing a batch)")
    ap.add_argument("--cost-report", action="store_true",
                    help="price the measured steps under BOTH backends at "
                         "exit and print the cost-time frontier comparison")
    # cost-aware auto-scheduler (repro_torch.core.scheduler)
    ap.add_argument("--scheduler", default=None,
                    choices=list(available_schedulers()),
                    help="pick next epoch's fleet plan from measured step "
                         "times at exit: sweeps serverless tiers, CPU/GPU "
                         "instances, and a mixed fleet")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="scheduler: epoch wall-clock deadline in seconds")
    ap.add_argument("--budget-usd", type=float, default=None,
                    help="scheduler: whole-cluster epoch budget in dollars")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on the CPU")

    runtime = (RuntimeConfig.aws_default() if args.runtime_preset == "aws"
               else RuntimeConfig())
    overrides = {}
    if args.failure_rate is not None:
        overrides["failure_rate"] = args.failure_rate
    if args.cold_start_s is not None:
        overrides["cold_start_s"] = args.cold_start_s
    if args.concurrency is not None:
        overrides["concurrency_limit"] = args.concurrency or None
    if args.straggler_prob is not None:
        overrides["straggler_prob"] = args.straggler_prob
    if overrides:
        runtime = dataclasses.replace(runtime, **overrides)

    instance_cfg = (InstanceConfig.aws_default()
                    if args.runtime_preset == "aws" else InstanceConfig())
    inst_overrides = {}
    if args.boot_s is not None:
        inst_overrides["boot_s"] = args.boot_s
    if args.instance_churn_prob is not None:
        inst_overrides["churn_prob"] = args.instance_churn_prob
    if inst_overrides:
        instance_cfg = dataclasses.replace(instance_cfg, **inst_overrides)

    get_exchange(args.exchange)  # fail fast on unknown/invalid NAME[:ARG]

    adversary = None
    if args.adversary_frac > 0 or args.adversary_num:
        adversary = AdversarySpec(
            fraction=args.adversary_frac, num=args.adversary_num,
            attack=args.attack, scale=args.adversary_scale,
            seed=args.adversary_seed,
        )

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, vocab_size=512)
    mesh = make_host_mesh(args.data_parallel, args.model_parallel)
    npeers = mesh["data"]
    print(f"mesh={mesh} peers={npeers} arch={cfg.name}")

    topo = Topology(
        exchange=args.exchange,
        graph=args.graph,
        graph_seed=args.graph_seed,
        qsgd=(
            QSGDConfig(levels=args.qsgd_levels, bucket=512)
            if args.exchange == "qsgd" else None
        ),
        staleness=args.staleness,
        topk_frac=args.topk_frac,
        ef=args.ef,
        trim_frac=args.trim_frac,
        krum_m=args.krum_m,
        robust_clip=args.robust_clip,
    )
    opt = adam() if args.optimizer == "adam" else sgd(momentum=0.9)
    sched = warmup_cosine(args.lr, args.steps // 10 + 1, args.steps)
    trainer = P2PTrainer(cfg, opt, topo, npeers, sched,
                         runtime=runtime, allocation=args.allocation,
                         backend=args.backend, instance_type=args.instance_type,
                         instance_config=instance_cfg, adversary=adversary,
                         scheduler=args.scheduler, device=device)
    if adversary is not None:
        print(f"adversary: {adversary.describe()} "
              f"(attackers={sorted(adversary.attackers(npeers))})")
    state = trainer.init_state(torch.Generator(device=device).manual_seed(0))
    if args.restore:
        state = trainer.restore(args.restore, state)
        print(f"restored checkpoint from {args.restore} (step {int(state.step)})")
    if npeers > 1:
        cc = trainer.comm_cost()
        print(f"graph: {trainer.graph.describe()}")
        print(f"exchange={topo.exchange}: {cc.summary()}")
        plan = trainer.shard_plan()
        if plan is not None:
            print(f"shard plan: {plan.describe()}")

    ds = make_dataset("lm", size=200_000, vocab_size=cfg.vocab_size, seq_len=args.seq)
    loader = DataLoader(Partitioner(ds, 1), 0, args.batch)
    detector = ConvergenceDetector(args.lr, mode="min", max_epochs=10**6)

    t0 = time.time()
    step_times = []
    for i in range(args.steps):
        batch = make_lm_batch(
            loader, BatchKey(0, i // loader.num_batches, i % loader.num_batches),
            cfg.vocab_size,
        )
        ts = time.time()
        state, metrics = trainer.step(state, batch)
        if args.serverless_report or args.cost_report or args.scheduler:
            _sync(device)
            step_times.append(time.time() - ts)
        if (i + 1) % args.log_every == 0 or i == 0:
            loss = float(metrics["loss"])
            print(
                f"step {i+1:5d} loss {loss:.4f} ce {float(metrics['aux'][0]):.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"({(time.time()-t0)/(i+1):.2f} s/step)"
            )
            if detector.step(loss):
                print("converged (early stop)")
                break
    if (args.serverless_report or args.cost_report or args.scheduler) \
            and step_times:
        # skip step 0 (warm-up); one "epoch" = the measured step batch
        times = step_times[1:] or step_times
        if args.serverless_report and args.backend == "instance":
            rep = trainer.account_instance(
                times, epoch=0, charge_exchange=npeers > 1
            )
            print(
                f"instance accounting [{args.instance_type}]: "
                f"{rep.num_batches} sequential batches x {rep.num_splits} "
                f"split(s), wall {rep.wall_time_s:.2f}s "
                f"(measured {rep.measured_compute_s:.2f}s), "
                f"boot={rep.boot_s:.1f}s wire={rep.wire_s:.2f}s "
                f"drops={rep.churn_drops} cost=${rep.cost_usd:.6f}"
            )
        elif args.serverless_report:
            rep = trainer.account_serverless(times, epoch=0)
            print(
                f"serverless accounting [{args.runtime_preset}/{args.allocation}]: "
                f"{rep.num_batches} invocations x {rep.lambda_memory_mb}MB, "
                f"wall {rep.wall_time_s:.2f}s (measured {rep.measured_compute_s:.2f}s), "
                f"cold_starts={rep.num_cold_starts} retries={rep.num_retries} "
                f"queue_wait={rep.queue_wait_s:.2f}s cost=${rep.cost_usd:.6f}"
            )
            if trainer.protocol.sharded:
                agg = trainer.account_aggregation(epoch=0)
                print(
                    f"sharded aggregation: {agg.num_batches} parallel aggregators "
                    f"x {agg.lambda_memory_mb}MB (sized from shard bytes), "
                    f"wall {agg.wall_time_s:.3f}s cold_starts={agg.num_cold_starts} "
                    f"cost=${agg.cost_usd:.6f}"
                )
        if args.cost_report:
            # gradient-computation scope, fresh accountants on both sides
            fr = trainer.cost_frontier(times)
            print(
                f"gradient-computation cost-time frontier "
                f"[{args.instance_type} baseline]: "
                f"serverless {fr['speedup_pct']:.2f}% faster at "
                f"{fr['cost_multiple']:.2f}x the cost "
                f"(serverless {fr['serverless_wall_s']:.2f}s/"
                f"${fr['serverless_usd']:.6f} vs instance "
                f"{fr['instance_wall_s']:.2f}s/${fr['instance_usd']:.6f} "
                f"per peer-epoch)"
            )
        if args.scheduler:
            # every peer runs the same measured step batch
            per_peer = [list(times)] * max(npeers, 2)
            try:
                pick = trainer.schedule_epoch(
                    per_peer,
                    deadline_s=args.deadline_s,
                    budget_usd=args.budget_usd,
                )
            except ValueError as e:
                print(f"scheduler [{args.scheduler}]: infeasible — {e}")
            else:
                rep = pick["report"]
                constraints = []
                if args.deadline_s is not None:
                    constraints.append(f"deadline {args.deadline_s:g}s")
                if args.budget_usd is not None:
                    constraints.append(f"budget ${args.budget_usd:g}")
                print(
                    f"scheduler [{args.scheduler}"
                    f"{' | ' + ', '.join(constraints) if constraints else ''}]: "
                    f"chose {pick['plan'].describe()} — epoch wall "
                    f"{rep.wall_time_s:.2f}s, cluster ${rep.total_usd:.6f} "
                    f"({len(pick['candidates'])} candidates measured)"
                )
    if args.checkpoint:
        trainer.save(args.checkpoint, state)
        print(f"saved checkpoint to {args.checkpoint}")
    return state


if __name__ == "__main__":
    main()
