"""Batched serving example of the port: greedy decode with KV caches across
three families, a twin of the reference's ``examples/serve_decode.py``.

Serves gemma2-2b (dense attention with sliding-window layers), mamba2-370m
(SSM) and zamba2-1.2b (hybrid), each reduced to 2 layers and a vocabulary
of 512 as the reference's example reduces them, with 4 batched requests of
48 greedy tokens, and prints per-family tokens/s: ``decode_step`` covers
attention caches, rolling windows and SSM states. The weights are random,
from a seeded ``torch.Generator``. Each decode step attends over its KV
cache through ``attend``, as the reference does; no prompt is prefilled.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode                # on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu
"""
import argparse
import time

import torch

from repro_torch import models
from repro_torch.configs import get_config, reduced
from repro_torch.core.simulate import resolve_device

ARCHS = ("gemma2-2b", "mamba2-370m", "zamba2-1.2b")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, *, batch: int = 4, gen: int = 48, device="cuda", model=None):
    """Decode ``gen`` greedy tokens for ``batch`` requests of ``arch``,
    starting from token 1 at position 0: one untimed step first (the
    reference's compile step, whose token feeds the timed ones), then
    ``gen`` timed steps. ``model``: weights to serve in place of a seeded
    initialisation. Prints the reference's line; returns the first step's
    logits (batch, vocab) and the tokens (batch, gen) as numpy."""
    device = resolve_device(device)
    cfg = reduced(get_config(arch), vocab_size=512)
    if model is None:
        model = models.init_model(cfg, generator=torch.Generator(device=device).manual_seed(0),
                                  device=device)
    with torch.inference_mode():
        state = models.init_decode_state(cfg, batch, gen + 8, device=device)
        tok = torch.ones((batch, 1), dtype=torch.int64, device=device)
        first, state = models.decode_step(model, state, tok, cfg)
        tok = first.argmax(-1)[:, None]
        _sync(device)
        t0 = time.perf_counter()
        outs = []
        for _ in range(gen):
            logits, state = models.decode_step(model, state, tok, cfg)
            tok = logits.argmax(-1)[:, None]
            outs.append(tok[:, 0])
        _sync(device)
        dt = time.perf_counter() - t0
    seqs = torch.stack(outs, 1).cpu().numpy()
    print(f"{arch:15s} [{cfg.family:6s}] {batch} reqs x {gen} tokens: "
          f"{batch*gen/dt:7.1f} tok/s   sample: {seqs[0][:10].tolist()}")
    return first.float().cpu().numpy(), seqs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for arch in ARCHS:
        serve(arch, device=args.device)


if __name__ == "__main__":
    main()
