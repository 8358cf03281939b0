"""End-to-end driver: P2P training of a ~100M-parameter LM through
``P2PTrainer``, the twin of ``examples/p2p_serverless_train.py``.

The peers are a stacked dimension on one card (``--peers``; 1 is the
reference's single worker, which exchanges nothing), exchanging QSGD
gradients by default, each clipped to a global norm of 1.0.

    PYTHONPATH=src python -m repro_torch.examples.p2p_serverless_train --steps 200   # on the card
    PYTHONPATH=src python -m repro_torch.examples.p2p_serverless_train --device cpu \\
        --steps 2 --batch 2 --seq 16
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.compression import QSGDConfig
from repro_torch.core.convergence import ConvergenceDetector
from repro_torch.core.exchange import available_exchanges
from repro_torch.core.p2p import Topology
from repro_torch.data import BatchKey, DataLoader, Partitioner, make_dataset
from repro_torch.optim import adam
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import P2PTrainer


def hundred_m_config():
    """~100M-param decoder LM in the qwen2.5 family (107M params)."""
    base = get_config("qwen2.5-3b")
    return dataclasses.replace(
        base, name="qwen-100m", num_layers=10, d_model=640, num_heads=10,
        num_kv_heads=2, d_ff=2560, vocab_size=32_768, head_dim=64, remat=False,
        serve_window=0,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--exchange", default="qsgd",
                    choices=list(available_exchanges()))
    ap.add_argument("--peers", type=int, default=1, help="peers P on the one card")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--checkpoint", default="build/p2p_lm_ckpt")
    args = ap.parse_args(argv)

    cfg = hundred_m_config()
    npeers = args.peers
    topo = Topology(
        exchange=args.exchange,
        qsgd=QSGDConfig(levels=127, bucket=2048),
        grad_clip=1.0,
    )
    opt = adam()
    sched = warmup_cosine(1e-3, 20, args.steps)
    trainer = P2PTrainer(cfg, opt, topo, npeers, sched, device=args.device)
    state = trainer.init_state(torch.Generator(device=trainer.device).manual_seed(0))
    nparams = sum(x.numel() for x in state.params.values())
    print(f"model: {cfg.name} ({nparams/1e6:.1f}M params), "
          f"peers={npeers}, exchange={args.exchange}")
    if npeers > 1:
        print(f"wire: {trainer.comm_cost().summary()}")

    ds = make_dataset("lm", size=100_000, vocab_size=cfg.vocab_size, seq_len=args.seq)
    loader = DataLoader(Partitioner(ds, 1), 0, args.batch)
    detector = ConvergenceDetector(1e-3, mode="min", plateau_patience=5,
                                   stop_patience=20, max_epochs=10**6)

    t0 = time.time()
    for i in range(args.steps):
        b = loader.load(BatchKey(0, i // loader.num_batches, i % loader.num_batches))
        batch = {"tokens": torch.from_numpy(b["tokens"]).long(),
                 "labels": torch.from_numpy(b["labels"]).long()}
        state, m = trainer.step(state, batch)
        if (i + 1) % 20 == 0 or i == 0:
            ce = float(m["aux"][0])  # peer 0's, as the reference prints (behaviour 21)
            dt = (time.time() - t0) / (i + 1)
            toks = args.batch * args.seq / dt
            print(f"step {i+1:4d}  ce={ce:.4f}  {dt*1e3:.0f} ms/step "
                  f"({toks:,.0f} tok/s)")
            if detector.step(ce):
                print("converged — early stop")
                break
    trainer.save(args.checkpoint, state)
    print(f"checkpoint saved: {args.checkpoint}.npz")
    return state


if __name__ == "__main__":
    main()
