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

The LM (:func:`lm_from_jax` / :func:`lm_to_jax`, and its optimizer
moments through :func:`opt_state_from_jax` with the LM's config) is mapped
by name, not rank: the reference stacks each period slot's layers on a
leading axis (``stack/j/mixer/in_proj`` is (n_groups, din, dout)), its convolution
weight ``conv_w`` is (K, C) and ``embed`` is (V_pad, d). Group g of slot j
is the port's layer ``g * period + j`` and ``tail/r`` its layer
``n_groups * period + r``; ``in_proj``, ``out_proj``, the attention's
``wq``, ``wk``, ``wv``, ``wo``, the MLP's ``w_gate``, ``w_up``, ``w_down``
(a MoE layer's ``shared`` expert's too), the MoE ``router`` and
``unembed`` (din, dout) are ``nn.Linear`` weights (dout, din),
``conv_w`` (K, C) is the port's depthwise (C, 1, K), and every other leaf
(norm scales, the attention biases ``bq``, ``bk``, ``bv``, the SSM
vectors, ``embed``, and a MoE layer's expert banks ``w_gate``, ``w_up``
(E, d, f) and ``w_down`` (E, f, d), told from an MLP's linears by their
rank) is unchanged. zamba2's ``shared_block/...`` leaves are the port's
``shared_block.*``; the VLM's ``projector`` (din, dout) is a linear weight.
Whisper's encoder-decoder stacks all its encoder layers on the leading axis
of ``encoder/...`` and its decoder layers on that of ``decoder/...``
(``decoder/cross/wq``, ``decoder/ln_cross/scale`` among them): layer i is
the port's ``encoder.i.*`` or ``decoder.i.*``.

``jax_order`` gives the order of JAX's tree flatten (sorted dict keys,
list entries by index), which is also the order in which the QSGD wire
format visits leaves.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import layer_grouping


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


def opt_state_from_jax(flat: Mapping[str, np.ndarray], *, device,
                       cfg: Optional[ModelConfig] = None):
    """A reference optimizer state, flattened as ``train/checkpoint.py:
    _flatten`` flattens it -> the port's: ``{}`` for plain SGD, the momentum
    dict for SGD with momentum, ``{"mu", "nu", "t"}`` for Adam(W). Each
    moment leaf takes its parameter's layout mapping: by rank for a CNN,
    or, with the LM's ``cfg``, by name as :func:`lm_from_jax` maps the
    params (so a reference LM train state, params and moments, starts the
    port's step)."""
    if cfg is None:
        leaves = lambda sub: from_jax(sub, device=device)
    else:
        leaves = lambda sub: lm_from_jax(sub, cfg, device=device)
    if "t" in flat:
        sub = lambda pre: {p[len(pre):]: a for p, a in flat.items() if p.startswith(pre)}
        return {
            "mu": leaves(sub("mu/")),
            "nu": leaves(sub("nu/")),
            "t": torch.tensor(int(np.asarray(flat["t"])), dtype=torch.int32, device=device),
        }
    return leaves(flat)


def opt_state_to_jax(state) -> Dict[str, np.ndarray]:
    """The port's optimizer state -> the reference's, flattened as
    ``_flatten`` flattens it (the inverse of :func:`opt_state_from_jax`)."""
    if "t" in state:
        out = {f"mu/{p}": a for p, a in to_jax(state["mu"]).items()}
        out.update({f"nu/{p}": a for p, a in to_jax(state["nu"]).items()})
        out["t"] = state["t"].cpu().numpy().copy()
        return out
    return to_jax(state)


_LM_LINEAR = ("in_proj", "out_proj", "unembed", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "router", "projector")
_ENCDEC_STACKS = ("encoder", "decoder")  # whisper's: every layer on the leading axis


def _lm_leaf_to_torch(path: str, arr: np.ndarray):
    """A reference LM leaf (path within its layer or at the top) -> (port
    name, tensor)."""
    last = path.rsplit("/", 1)[-1]
    t = torch.from_numpy(np.array(arr, dtype=np.float32))
    name = torch_name(path)
    if last in _LM_LINEAR and t.dim() == 2:  # a 3-d MoE expert bank keeps its layout
        return f"{name}.weight", t.t().contiguous()
    if last == "conv_w":
        return name, t.t().contiguous()[:, None, :]
    return name, t


def _lm_layout_to_jax(name: str, t: torch.Tensor):
    """A port LM parameter (name within its layer or at the top) -> (reference
    path, the tensor in the reference's layout, a view); the one place that
    says which leaves change layout, for tensors and for shapes alike."""
    parts = name.split(".")
    if parts[-1] == "weight" and parts[-2] in _LM_LINEAR:
        return jax_path(".".join(parts[:-1])), t.t()
    if parts[-1] == "conv_w":
        return jax_path(name), t[:, 0, :].t()
    return jax_path(name), t


def _lm_leaf_to_jax(name: str, t: torch.Tensor):
    """A port LM parameter -> (reference path, numpy array); the inverse of
    :func:`_lm_leaf_to_torch`."""
    path, t = _lm_layout_to_jax(name, t.detach().cpu())
    return path, t.numpy().copy()


def _lm_shape_to_jax(name: str, shape) -> tuple:
    """A port LM parameter's name and shape -> (reference path, shape in the
    reference's layout)."""
    path, t = _lm_layout_to_jax(name, torch.empty(tuple(shape), device="meta"))
    return path, tuple(t.shape)


def lm_from_jax(flat: Mapping[str, np.ndarray], cfg: ModelConfig, *, device) -> Dict[str, torch.Tensor]:
    """Reference LM ``{path: array}`` -> the port's ``LM`` (or ``EncDec``)
    state dict ``{name: float32 tensor}`` on ``device``."""
    period, n_groups, _ = layer_grouping(cfg)
    out = {}
    for path in sorted(flat):
        parts = path.split("/")
        if parts[0] in _ENCDEC_STACKS:
            rest = "/".join(parts[1:])
            for i, arr in enumerate(flat[path]):
                name, t = _lm_leaf_to_torch(rest, arr)
                out[f"{parts[0]}.{i}.{name}"] = t.to(device)
        elif parts[0] in ("stack", "tail"):
            slot, rest = int(parts[1]), "/".join(parts[2:])
            if parts[0] == "stack":
                layers = [(g * len(period) + slot, flat[path][g]) for g in range(n_groups)]
            else:
                layers = [(n_groups * len(period) + slot, flat[path])]
            for layer, arr in layers:
                name, t = _lm_leaf_to_torch(rest, arr)
                out[f"layers.{layer}.{name}"] = t.to(device)
        else:
            name, t = _lm_leaf_to_torch(path, flat[path])
            out[name] = t.to(device)
    return out


def _lm_tree_to_jax(params: Mapping, cfg: ModelConfig, leaf, stack) -> Dict:
    """The port's ``{name: leaf}`` -> the reference's ``{path: leaf}``, each
    leaf through ``leaf(name, x) -> (path, y)``, slot layers joined on a
    leading axis by ``stack(list)``."""
    period, n_groups, _ = layer_grouping(cfg)
    per_layer: Dict[int, Dict] = {}
    stacked: Dict[str, Dict] = {}
    out = {}
    for name, t in params.items():
        parts = name.split(".")
        if parts[0] in _ENCDEC_STACKS:
            path, arr = leaf(".".join(parts[2:]), t)
            stacked.setdefault(f"{parts[0]}/{path}", {})[int(parts[1])] = arr
        elif parts[0] == "layers":
            path, arr = leaf(".".join(parts[2:]), t)
            per_layer.setdefault(int(parts[1]), {})[path] = arr
        else:
            path, arr = leaf(name, t)
            out[path] = arr
    for path, layers in stacked.items():
        out[path] = stack([layers[i] for i in range(len(layers))])
    P = len(period)
    for j in range(P if per_layer else 0):
        for path in per_layer[j]:
            out[f"stack/{j}/{path}"] = stack([per_layer[g * P + j][path] for g in range(n_groups)])
    for layer in sorted(per_layer):
        if layer >= n_groups * P:
            for path, arr in per_layer[layer].items():
                out[f"tail/{layer - n_groups * P}/{path}"] = arr
    return {k: out[k] for k in sorted(out)}


def lm_to_jax(
    model_or_params: Union[nn.Module, Mapping[str, torch.Tensor]], cfg: ModelConfig
) -> Dict[str, np.ndarray]:
    """The port's LM or EncDec (a module or its ``{name: tensor}``) -> the reference's
    flat ``{path: numpy array}``, slot layers stacked on a leading axis; the
    inverse of :func:`lm_from_jax`."""
    params = (dict(model_or_params.named_parameters())
              if isinstance(model_or_params, nn.Module) else dict(model_or_params))
    return _lm_tree_to_jax(params, cfg, _lm_leaf_to_jax, np.stack)


def lm_jax_shapes(shapes: Mapping[str, tuple], cfg: ModelConfig) -> Dict[str, tuple]:
    """The port's LM or EncDec ``{name: shape}`` -> the reference's ``{path:
    shape}`` (its layouts, slot layers stacked): :func:`lm_to_jax` on shapes,
    for the meta device and the sharding rules."""
    return _lm_tree_to_jax(shapes, cfg, _lm_shape_to_jax,
                           lambda xs: (len(xs),) + tuple(xs[0]))
