"""Config registry of the port: the paper's three CNNs, ``get_config(name)``.

The LM architectures of the reference's registry come with the LM side of
the port (ROADMAP.md, Queue 1, "LM side").
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

# arch id -> module name
_ARCH_MODULES = {
    "vgg11": "vgg11",
    "mobilenet-v3-small": "mobilenet_v3_small",
    "squeezenet1.1": "squeezenet1_1",
}

PAPER_ARCHS = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(_ARCH_MODULES)}"
        )
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in _ARCH_MODULES}


__all__ = ["ModelConfig", "get_config", "all_configs", "PAPER_ARCHS"]
