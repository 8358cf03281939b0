"""Config registry of the port: ``get_config(name)`` / ``--arch <id>``.

The paper's three CNNs and every LM architecture of the reference's
registry: Mamba-2, the dense attention LMs, zamba2's hybrid, the MoE LMs,
whisper's encoder-decoder and the internvl2 VLM stub (``LM_ARCHS``); and
the LMs of the port alone, which the reference's registry lacks
(``PORT_ARCHS``: Zamba2-7B in its release layout).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    reduced,
)

LM_ARCHS = ("mamba2-370m", "gemma2-2b", "qwen2.5-3b", "starcoder2-3b", "zamba2-1.2b",
            "granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "dbrx-132b", "whisper-base",
            "internvl2-26b")
PORT_ARCHS = ("zamba2-7b",)  # the port's own: no reference config to hold them to
PAPER_ARCHS = ("vgg11", "mobilenet-v3-small", "squeezenet1.1")  # the paper's own models
# arch id -> module name
_ARCH_MODULES = {name: name.replace("-", "_").replace(".", "_") for name in
                 LM_ARCHS + PORT_ARCHS + PAPER_ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(_ARCH_MODULES)}"
        )
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in _ARCH_MODULES}


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
           "LONG_500K", "reduced", "get_config", "all_configs", "LM_ARCHS", "PORT_ARCHS",
           "PAPER_ARCHS"]
