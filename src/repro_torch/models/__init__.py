"""Model API of the port, over the families ported so far.

``batch`` dicts carry, depending on family:
  tokens  (B, S) int        — the LM (numpy or a tensor)
  images  (B, H, W, C)      — CNN, NHWC numpy, moved to the model's
                              device as NCHW
  labels  (B,)              — CNN training targets

The CNNs and the Mamba-2 (``ssm``), dense, hybrid (zamba2) and MoE LMs are
ported; the encoder-decoder and VLM families raise ``NotImplementedError``
naming their ROADMAP item. ``moe_dispatch`` ("dense" or "capacity") picks a
MoE layer's dispatch, as in the reference; other families ignore it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn as _cnn
from repro_torch.models import transformer as _tf


def init_model(cfg: ModelConfig, *, generator: torch.Generator, device) -> nn.Module:
    """A freshly initialized model whose weights come from ``generator``."""
    if cfg.family == "cnn":
        return _cnn.init_cnn(cfg, generator=generator, device=device)
    return _tf.LM(cfg, generator=generator, device=device)


def images_to_device(images: np.ndarray, device) -> torch.Tensor:
    """NHWC numpy images -> contiguous NCHW float32 tensor on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
    return x.to(device).permute(0, 3, 1, 2).contiguous()


def _tokens(tokens, model: nn.Module) -> torch.Tensor:
    """(B, S) int tokens (numpy or a tensor) -> int64 on the model's device."""
    return torch.as_tensor(tokens, dtype=torch.int64).to(next(model.parameters()).device)


def forward(
    model: nn.Module, batch: Dict, cfg: ModelConfig, *, moe_dispatch: str = "dense",
    use_ssd_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits, aux_loss); aux_loss is the MoE layers' summed router
    loss, 0 for the CNNs and the LMs without MoE. ``use_ssd_kernel`` sends
    the LM's full-sequence SSD scans through the hand-written kernel;
    attention always takes the flash kernel (its plain version on the
    CPU)."""
    if cfg.family == "cnn":
        device = next(model.parameters()).device
        logits = model(images_to_device(batch["images"], device))
        return logits, torch.zeros((), dtype=torch.float32, device=device)
    return _tf.lm_forward(model, _tokens(batch["tokens"], model), cfg,
                          moe_dispatch=moe_dispatch, use_ssd_kernel=use_ssd_kernel)


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int, *, device="cuda"):
    if cfg.family == "cnn":
        raise ValueError("CNNs have no decode step")
    return _tf.init_decode_state(cfg, batch, seq_len, device=device)


def prefill(model: nn.Module, state, batch: Dict, cfg: ModelConfig, *,
            moe_dispatch: str = "dense"):
    """One-shot prompt prefill into a decode state. Returns
    (last-token logits, state positioned after the prompt); the prompt's
    attention goes through the flash kernel.

    Consumes ``state``: the attention layers' KV caches are written in
    place and the same buffers returned (the reference returns new ones),
    so clone a state you mean to keep. Mamba-2 layers get new states."""
    if cfg.family == "cnn":
        raise ValueError("CNNs have no decode step")
    return _tf.lm_prefill(model, state, _tokens(batch["tokens"], model), cfg,
                          moe_dispatch=moe_dispatch)


def decode_step(model: nn.Module, state, token, cfg: ModelConfig, *,
                moe_dispatch: str = "dense"):
    """One decode step of ``token`` (B, 1). Returns (logits (B, vocab), the
    state one position on); it consumes ``state`` as ``prefill`` does."""
    if cfg.family == "cnn":
        raise ValueError("CNNs have no decode step")
    return _tf.lm_decode_step(model, state, _tokens(token, model), cfg,
                              moe_dispatch=moe_dispatch)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
