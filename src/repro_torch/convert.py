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


def _permute(t: torch.Tensor, lead: int, perm4, perm2) -> torch.Tensor:
    perm = {4: perm4, 2: perm2}.get(t.dim() - lead)
    if perm is None:
        return t
    return t.permute(*range(lead), *(lead + d for d in perm))


def to_jax_layout(t: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """A port tensor in the reference's layout (a view). ``lead`` leading
    dimensions (a stacked peer dimension) are kept in front as they are."""
    return _permute(t, lead, (2, 3, 1, 0), (1, 0))


def to_torch_layout(t: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """A tensor in the reference's layout -> the port's layout, contiguous;
    ``lead`` leading dimensions are kept in front as they are."""
    return _permute(t, lead, (3, 2, 0, 1), (1, 0)).contiguous()


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


def opt_state_from_jax(flat: Mapping[str, np.ndarray], *, device):
    """A reference optimizer state, flattened as ``train/checkpoint.py:
    _flatten`` flattens it -> the port's: ``{}`` for plain SGD, the momentum
    dict for SGD with momentum, ``{"mu", "nu", "t"}`` for Adam(W). Each
    moment leaf takes its parameter's layout mapping."""
    if "t" in flat:
        sub = lambda pre: {p[len(pre):]: a for p, a in flat.items() if p.startswith(pre)}
        return {
            "mu": from_jax(sub("mu/"), device=device),
            "nu": from_jax(sub("nu/"), device=device),
            "t": torch.tensor(int(np.asarray(flat["t"])), dtype=torch.int32, device=device),
        }
    return from_jax(flat, device=device)


def opt_state_to_jax(state) -> Dict[str, np.ndarray]:
    """The port's optimizer state -> the reference's, flattened as
    ``_flatten`` flattens it (the inverse of :func:`opt_state_from_jax`)."""
    if "t" in state:
        out = {f"mu/{p}": a for p, a in to_jax(state["mu"]).items()}
        out.update({f"nu/{p}": a for p, a in to_jax(state["nu"]).items()})
        out["t"] = state["t"].cpu().numpy().copy()
        return out
    return to_jax(state)
