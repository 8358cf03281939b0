"""Carry weights between the reference's JAX param pytrees and the port.

The reference side is a flat ``{path: numpy array}`` dict keyed by the path
strings of ``repro/train/checkpoint.py:_flatten`` (``blocks/0/dw/w``); the
port side is ``{name: tensor}`` keyed by ``nn.Module`` parameter names
(``blocks.0.dw.w``). Layouts:

* convolution ``w``: HWIO ``(kh, kw, cin/groups, cout)`` <-> OIHW
  ``(cout, cin/groups, kh, kw)`` — a depthwise ``(k, k, 1, C)`` becomes
  ``(C, 1, k, k)``;
* linear ``w``: ``(din, dout)`` <-> ``(dout, din)``;
* biases and BatchNorm vectors are unchanged.

The CNNs' only 4-d leaves are convolution kernels and their only 2-d
leaves are linear weights, so the rank of a leaf picks its mapping.

``jax_order`` gives the order of JAX's tree flatten (sorted dict keys,
list entries by index), which is also the order in which the QSGD wire
format visits leaves.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping

import numpy as np
import torch


def jax_path(name: str) -> str:
    return name.replace(".", "/")


def torch_name(path: str) -> str:
    return path.replace("/", ".")


def jax_order(names: Iterable[str]) -> List[str]:
    """``names`` sorted as ``jax.tree_util.tree_flatten`` visits the leaves."""
    def key(name: str):
        return tuple((0, int(c), "") if c.isdigit() else (1, 0, c) for c in name.split("."))

    return sorted(names, key=key)


def to_jax_layout(t: torch.Tensor) -> torch.Tensor:
    """A port tensor in the reference's layout (a view where possible)."""
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    if t.dim() == 2:
        return t.t()
    return t


def to_torch_layout(t: torch.Tensor) -> torch.Tensor:
    """A tensor in the reference's layout -> the port's layout, contiguous."""
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1).contiguous()
    if t.dim() == 2:
        return t.t().contiguous()
    return t


def from_jax(flat: Mapping[str, np.ndarray], *, device) -> Dict[str, torch.Tensor]:
    """Reference ``{path: array}`` -> port ``{name: float32 tensor}`` on
    ``device``, in JAX leaf order."""
    out = {}
    for name in jax_order(torch_name(p) for p in flat):
        arr = np.asarray(flat[jax_path(name)], dtype=np.float32)
        out[name] = to_torch_layout(torch.from_numpy(arr.copy())).to(device)
    return out


def to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Port ``{name: tensor}`` -> reference ``{path: numpy array}``, in JAX
    leaf order."""
    return {
        jax_path(name): to_jax_layout(params[name].detach()).cpu().numpy().copy()
        for name in jax_order(params)
    }
