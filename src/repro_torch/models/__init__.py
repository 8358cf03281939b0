"""Model API of the port: ``init_model`` / ``forward`` for ``family == "cnn"``.

``forward`` takes the reference's batch dict — ``images`` (B, H, W, C) NHWC
numpy, ``labels`` (B,) — and moves the images to the model's device as
NCHW. The LM families come with the LM side of the port (ROADMAP.md,
Queue 1, "LM side").
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn as _cnn


def _cnn_only(cfg: ModelConfig) -> None:
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet: ROADMAP.md, "
            "Queue 1, 'LM side'"
        )


def init_model(cfg: ModelConfig, *, generator: torch.Generator, device) -> nn.Module:
    """A freshly initialized model whose weights come from ``generator``."""
    _cnn_only(cfg)
    return _cnn.init_cnn(cfg, generator=generator, device=device)


def images_to_device(images: np.ndarray, device) -> torch.Tensor:
    """NHWC numpy images -> contiguous NCHW float32 tensor on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
    return x.to(device).permute(0, 3, 1, 2).contiguous()


def forward(
    model: nn.Module, batch: Dict[str, np.ndarray], cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits, aux_loss); aux_loss is 0 for the CNNs."""
    _cnn_only(cfg)
    device = next(model.parameters()).device
    logits = model(images_to_device(batch["images"], device))
    return logits, torch.zeros((), dtype=torch.float32, device=device)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
