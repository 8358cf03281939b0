"""Decoder-only LM of the port, for ``family == "ssm"`` (Mamba-2).

A copy of the SSM path of the reference's ``repro/models/transformer.py``.
The reference stacks the layers of each period slot on a leading axis and
scans over the groups (``lax.scan``); here the layers are an
``nn.ModuleList`` run in order, layer ``g * period + j`` being group g of
slot j. ``convert.lm_from_jax`` / ``lm_to_jax`` carry weights across that
layout (``layer_grouping`` gives it).

Every other family raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import ssm as S
from repro_torch.models.layers import RMSNorm, dense_init, rmsnorm, softcap

DecodeState = Dict[str, object]


def require_ported(cfg: ModelConfig) -> None:
    """Raise for a family whose layers are not ported yet."""
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet: only the Mamba-2 (ssm) LM is; "
            "ROADMAP.md, Queue 1, item 11, 'LM side'"
        )


def layer_grouping(cfg: ModelConfig) -> Tuple[Tuple[BlockSpec, ...], int, int]:
    """Return (period_specs, n_groups, n_remainder), as the reference's."""
    specs = cfg.block_specs()
    Lnum = len(specs)
    for p in range(1, Lnum + 1):
        if Lnum % p and (Lnum // p) * p + (Lnum % p) != Lnum:
            continue
        n = Lnum // p
        if n == 0:
            continue
        ok = all(specs[i] == specs[i % p] for i in range(n * p))
        if ok and n >= 1:
            return specs[:p], n, Lnum - n * p
    return specs, 1, 0


class Block(nn.Module):
    """``ln1`` and the Mamba-2 mixer (``ffn == "none"``)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator, device):
        super().__init__()
        pdt = getattr(torch, cfg.param_dtype)
        self.ln1 = RMSNorm(cfg.d_model, device=device, dtype=pdt)
        self.mixer = S.Mamba2(cfg, generator=generator, device=device)

    def forward(self, x, cfg, *, cache=None, use_ssd_kernel=False):
        y, new_cache = S.mamba2_apply(self.mixer, self.ln1(x, cfg.norm_eps), cfg, state=cache,
                                      use_kernel=use_ssd_kernel)
        return x + y, new_cache


class LM(nn.Module):
    """Embedding, the blocks, ``final_norm``, and the tied or untied
    unembedding."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator, device):
        super().__init__()
        require_ported(cfg)
        pdt = getattr(torch, cfg.param_dtype)
        emb = torch.randn((cfg.padded_vocab, cfg.d_model), generator=generator, device=device)
        self.embed = nn.Parameter((emb * 0.02).to(pdt))
        self.final_norm = RMSNorm(cfg.d_model, device=device, dtype=pdt)
        if not cfg.tie_embeddings:
            self.unembed = skip_init(nn.Linear, cfg.d_model, cfg.padded_vocab, bias=False,
                                     device=device, dtype=pdt)
            self.unembed.weight.data = dense_init(cfg.d_model, cfg.padded_vocab,
                                                  generator=generator, device=device, dtype=pdt)
        self.layers = nn.ModuleList(
            Block(cfg, generator=generator, device=device) for _ in range(cfg.num_layers))

    def embed_tokens(self, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        # gather, then cast: the same values as the reference's cast-then-gather
        return self.embed[tokens.to(self.embed.device)].to(getattr(torch, cfg.dtype))

    def unembed_logits(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        w = self.embed if cfg.tie_embeddings else self.unembed.weight
        logits = F.linear(x, w.to(x.dtype))
        if cfg.padded_vocab != cfg.vocab_size:
            logits = logits[..., : cfg.vocab_size]
        return softcap(logits.to(torch.float32), cfg.final_logit_softcap)

    def run(self, x, cfg, *, caches: Optional[List] = None, use_ssd_kernel: bool = False):
        new_caches = []
        for i, block in enumerate(self.layers):
            x, nc = block(x, cfg, cache=None if caches is None else caches[i],
                          use_ssd_kernel=use_ssd_kernel)
            new_caches.append(nc)
        return rmsnorm(x, self.final_norm.scale, cfg.norm_eps), new_caches


def lm_forward(
    model: LM, tokens: torch.Tensor, cfg: ModelConfig, *, use_ssd_kernel: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (scoring). Returns (logits (B, S, vocab) f32, aux)."""
    x, _ = model.run(model.embed_tokens(tokens, cfg), cfg, use_ssd_kernel=use_ssd_kernel)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return model.unembed_logits(x, cfg), aux


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int, *, device) -> DecodeState:
    """Each layer's SSM and convolution state, in layer order (``seq_len``
    sizes the attention families' caches, which the SSM LM has none of)."""
    require_ported(cfg)
    dt = getattr(torch, cfg.dtype)
    return {
        "pos": 0,
        "layers": [S.init_mamba2_state(cfg, batch, dt, device=device)
                   for _ in range(cfg.num_layers)],
    }


def lm_prefill(
    model: LM, state: DecodeState, tokens: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, DecodeState]:
    """One-shot prefill of the prompt (B, S) into every layer's state.
    Returns (last-token logits (B, vocab), the state at position S)."""
    x, new_caches = model.run(model.embed_tokens(tokens, cfg), cfg, caches=state["layers"])
    logits = model.unembed_logits(x[:, -1:], cfg)[:, 0]
    return logits, {"pos": tokens.shape[1], "layers": new_caches}


def lm_decode_step(
    model: LM, state: DecodeState, token: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step of token (B, 1): returns (logits (B, vocab), new state)."""
    x, new_caches = model.run(model.embed_tokens(token, cfg), cfg, caches=state["layers"])
    logits = model.unembed_logits(x, cfg)[:, 0]
    return logits, {"pos": state["pos"] + 1, "layers": new_caches}
