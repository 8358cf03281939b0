"""Serving entry point of the port: batched greedy (or sampled) decode after a
one-shot prefill, a twin of the reference's ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --full --batch 4 \\
        --prompt-len 512 --gen 32                       # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced --gen 4

``--arch`` defaults to gemma2-2b, as in the reference; the Mamba-2, dense,
hybrid and MoE LMs are served (``--arch mamba2-370m``, ``qwen2.5-3b``,
``starcoder2-3b``, ``zamba2-1.2b``, ``granite-moe-3b-a800m``,
``moonshot-v1-16b-a3b``, ``dbrx-132b``; a MoE layer takes the dense
dispatch, the reference's default). The prefill's attention goes through
the flash kernel (its plain version for a model on the CPU); decode attends over the KV
cache with the plain ``attend``, as the reference does. The weights are
random, from a seeded ``torch.Generator``, or ``--checkpoint``'s: a v1
params checkpoint or a v2 train state's params, written by either
package's trainer (``train.checkpoint.restore_params``).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch

from repro_torch import models
from repro_torch.configs import get_config, reduced
from repro_torch.train import checkpoint as ckpt


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(
    model: torch.nn.Module,
    cfg,
    prompts: torch.Tensor,  # (B, prompt_len) int64
    gen: int,
    *,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, object]:
    """Prefill the prompts, then decode ``gen`` tokens (the first from the
    prefill's logits). Returns the tokens (B, gen) as numpy, the prefill's
    last-token logits, and the host-clock seconds of the prefill and of the
    ``gen - 1`` decode steps, each ended by a device sync."""
    device = next(model.parameters()).device
    B, prompt_len = prompts.shape

    def pick(logits):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)
        return logits.argmax(-1)[:, None]

    with torch.inference_mode():
        state = models.init_decode_state(cfg, B, prompt_len + gen, device=device)
        _sync(device)
        t0 = time.perf_counter()
        logits, state = models.prefill(model, state, {"tokens": prompts}, cfg)
        tok = pick(logits)
        out = [tok]
        _sync(device)
        t1 = time.perf_counter()
        for _ in range(gen - 1):
            step_logits, state = models.decode_step(model, state, tok, cfg)
            tok = pick(step_logits)
            out.append(tok)
        _sync(device)
        t2 = time.perf_counter()
    return {
        "tokens": torch.cat(out, dim=1).cpu().numpy(),
        "prefill_logits": logits,
        "prefill_s": t1 - t0,
        "decode_s": t2 - t1,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, vocab_size=512)
    if cfg.family == "cnn":
        raise SystemExit("CNNs are not served autoregressively")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to serve on the CPU")
    if args.gen < 1:
        raise SystemExit("--gen must be at least 1")

    model = models.init_model(cfg, generator=torch.Generator(device=device).manual_seed(0),
                              device=device)
    if args.checkpoint:
        params, meta = ckpt.restore_params(args.checkpoint, dict(model.named_parameters()), cfg)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(params[name])
        print(f"restored checkpoint (step {meta.get('step')})")
    B = args.batch
    sampler = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, args.prompt_len), generator=sampler,
                            device=device)
    res = generate(model, cfg, prompts, args.gen, temperature=args.temperature, generator=sampler)
    gen = res["tokens"]
    total = res["prefill_s"] + res["decode_s"]
    toks_per_s = B * (args.prompt_len + args.gen) / total
    per_token = res["decode_s"] / max(args.gen - 1, 1)
    print(f"generated {gen.shape} in {total:.2f}s ({toks_per_s:.1f} tok/s incl. prefill) on "
          f"{device}: prefill {res['prefill_s']:.3f} s, decode {per_token * 1e3:.2f} ms/token")
    for b in range(min(B, 2)):
        print(f"request {b}: {gen[b][:24].tolist()}")
    return gen


if __name__ == "__main__":
    main()
