"""The reference's sharding rules on shapes: the twin of the reference's
``repro/launch/sharding.py``.

The reference shards over a TPU mesh in two regimes, chosen per
architecture. Regime A (non-FSDP archs): the peers are the ("pod", "data")
axes and the "model" axis is the serverless Lambda pool, each slot a
micro-batch; parameters are stored sharded over "model" (ZeRO-3) and
gathered per layer. Regime B (``fsdp=True``: dbrx-132b, internvl2-26b,
moonshot-v1-16b-a3b): the peers are pods, and within a pod weights shard
over "data" (FSDP) and "model" (tensor parallel). Prefill and decode use
the tensor-parallel activation rules.

The port runs on one card and places nothing: a mesh is a ``{axis: size}``
mapping (``launch/mesh.py``) and a spec is a tuple with one entry per
dimension, ``None``, an axis name, or a tuple of axis names (the
reference's ``PartitionSpec`` entries). The rules are the reference's,
line for line. The dry run reads them for one number,
``per_chip_bytes``: what one chip of the reference's layout would hold.

Parameter specs take the reference's parameter paths and layouts
(``stack/0/attn/wq`` (groups, d, H hd)); ``convert.lm_jax_shapes`` maps the
port's state to them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

Mesh = Mapping[str, int]
Spec = Tuple[Any, ...]

MIN_SHARD_SIZE = 1 << 14  # leaves smaller than this stay replicated

# weight-name classes for Megatron-style column/row splits
_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "unembed"}
_ROW_PARALLEL = {"wo", "w_down", "out_proj"}
_EXPERT_NAMES = {"w_gate", "w_up", "w_down"}
_OPT_PREFIXES = ("mu", "nu", "momentum")


def _div(dim: int, size: int) -> bool:
    return dim % size == 0


def sanitize_spec(shape: Tuple[int, ...], spec: Spec, mesh: Mesh) -> Spec:
    """Drop spec axes whose size doesn't divide the corresponding dim
    (the reference's jit ``in_shardings`` need exact divisibility)."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        keep = []
        prod = 1
        for a in axes:
            sz = mesh[a]
            if _div(shape[i], prod * sz):
                keep.append(a)
                prod *= sz
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(tuple(keep))
    return tuple(out)


def param_spec(keys: Tuple[str, ...], shape: Tuple[int, ...], cfg: ModelConfig,
               mesh: Mesh) -> Spec:
    """The spec of one parameter at reference path ``keys`` and reference
    layout ``shape`` (before ``sanitize_spec``)."""
    if len(shape) == 0 or math.prod(shape) < MIN_SHARD_SIZE:
        return ()
    msz = mesh["model"]
    dsz = mesh.get("data", 1)
    spec: list = [None] * len(shape)
    start = (
        1
        if keys and keys[0] in ("stack", "encoder", "decoder") and len(shape) > 1
        else 0
    )
    name = keys[-1] if keys else ""
    cand = list(range(start, len(shape)))

    model_dim = None
    is_expert = name in _EXPERT_NAMES and (len(shape) - start == 3)
    if is_expert and _div(shape[start], msz):
        model_dim = start  # expert-parallel
    elif is_expert:
        # E not divisible (granite's 40 experts on a 16-wide axis): Megatron
        # within each expert, w_gate/w_up column-parallel, w_down row-parallel
        model_dim = (len(shape) - 1) if name in ("w_gate", "w_up") else start + 1
    elif name in _ROW_PARALLEL and _div(shape[start], msz):
        model_dim = start
    elif name in _COL_PARALLEL and _div(shape[-1], msz):
        model_dim = len(shape) - 1
    elif name == "embed" and _div(shape[0], msz):
        model_dim = 0  # vocab-sharded embedding
    if model_dim is None:
        order = sorted(cand, key=lambda i: shape[i], reverse=True)
        for i in order:
            if _div(shape[i], msz):
                model_dim = i
                break
        if model_dim is None:
            for i in order:
                if shape[i] >= msz:
                    model_dim = i
                    break
    if model_dim is not None:
        spec[model_dim] = "model"
    # embedding tables keep a single sharded axis, as in the reference
    if name in ("embed", "unembed"):
        return tuple(spec)
    if cfg.fsdp and dsz > 1:
        rest = sorted((i for i in cand if i != model_dim), key=lambda i: shape[i], reverse=True)
        for i in rest:
            if _div(shape[i], dsz) or shape[i] >= 4 * dsz:
                spec[i] = "data"
                break
    return tuple(spec)


def param_specs(shapes: Mapping[str, Tuple[int, ...]], cfg: ModelConfig,
                mesh: Mesh) -> Dict[str, Spec]:
    """``{reference path: shape}`` of params or optimizer state -> ``{path:
    sanitized spec}`` (the reference's ``param_shardings``: an optimizer
    leaf under ``mu``, ``nu`` or ``momentum`` takes its parameter's spec)."""
    out = {}
    for path, shape in shapes.items():
        keys = tuple(path.split("/"))
        while keys and keys[0] in _OPT_PREFIXES:
            keys = keys[1:]
        shape = tuple(shape)
        out[path] = sanitize_spec(shape, param_spec(keys, shape, cfg, mesh), mesh)
    return out


# ---------------------------------------------------------------------------
# Activation logical-axis rules
# ---------------------------------------------------------------------------


def _fits(n: int, sz: int) -> bool:
    return n % sz == 0 and n >= sz


def activation_rules(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *,
                     peer_axes: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """The reference's logical-axis rules for one (arch, shape)."""
    msz = mesh["model"]
    batch_axes = [a for a in mesh if a != "model"]
    B = shape.global_batch

    chosen_batch: list = []
    nbatch = 1
    for a in batch_axes:
        if _fits(B, nbatch * mesh[a]):
            chosen_batch.append(a)
            nbatch *= mesh[a]

    if shape.mode == "train" and not cfg.fsdp:
        # Regime A: Lambda (batch) parallelism over "model"; tensor rules off
        return {
            "batch": (tuple(chosen_batch) or ()) + ("model",),
            "embed": None, "ff": None, "heads": None, "kv_heads": None,
            "experts": None, "vocab": None, "kv_seq": None, "seq": None,
        }

    rules: Dict[str, Any] = {
        "batch": tuple(chosen_batch) or None,
        "seq": None,
        "embed": None,
        "ff": "model" if cfg.d_ff and _fits(cfg.d_ff, msz) else None,
        "heads": "model" if cfg.num_heads and _fits(cfg.num_heads, msz) else None,
        "kv_heads": "model" if cfg.num_kv_heads and _fits(cfg.num_kv_heads, msz) else None,
        "experts": "model" if cfg.num_experts >= msz else None,
        "vocab": "model" if cfg.vocab_size >= 4 * msz else None,
        "kv_seq": None,
    }
    if cfg.ssm_state and _fits(cfg.ssm_heads, msz):
        rules["heads"] = "model"
    if shape.mode == "decode":
        spare = tuple(a for a in batch_axes if a not in chosen_batch)
        kv_axes = (() if rules["kv_heads"] else ("model",)) + spare
        rules["kv_seq"] = kv_axes if kv_axes else None
    return rules


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, rules) -> Tuple[dict, dict]:
    """({name: (shape, dtype)}, {name: spec}) of a train or prefill batch:
    the reference's leaves and specs. Tokens and labels are int64, as the
    port's models take them (the reference's are int32)."""
    B, S = shape.global_batch, shape.seq_len
    bspec = sanitize_spec((B, S), (rules["batch"],) if rules["batch"] else (), mesh)
    out = {"tokens": ((B, S), torch.int64)}
    specs = {"tokens": bspec}
    if shape.mode == "train":
        out["labels"] = ((B, S), torch.int64)
        specs["labels"] = bspec
    if cfg.family == "vlm":
        out["patches"] = ((B, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
        specs["patches"] = bspec
    if cfg.family == "encdec":
        out["frames"] = ((B, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
        specs["frames"] = bspec
    return out, specs


def decode_state_specs(state, cfg: ModelConfig, mesh: Mesh, rules):
    """Specs for a decode state (nested dicts and lists of tensors or
    shapes), by each leaf's key: ``k``/``v`` (.., B, S, K, hd), ``ssm``
    (.., B, H, P, N), ``conv`` (.., B, K-1, C); others replicated."""
    batch_rule, kvh, kvs, heads = rules["batch"], rules["kv_heads"], rules["kv_seq"], rules["heads"]

    def spec_for(key, shape):
        nd = len(shape)
        spec = [None] * nd
        if key in ("k", "v") and nd >= 4:
            lead = nd - 4
            spec[lead + 0] = batch_rule
            spec[lead + 1] = kvs
            spec[lead + 2] = kvh
        elif key == "ssm" and nd >= 4:
            lead = nd - 4
            spec[lead + 0] = batch_rule
            spec[lead + 1] = heads
        elif key == "conv" and nd >= 3:
            spec[nd - 3] = batch_rule
        return sanitize_spec(shape, tuple(spec), mesh)

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        if isinstance(node, torch.Tensor):
            return spec_for(key, tuple(node.shape))
        return ()  # a host scalar (the position)

    return walk(state, None)


def shard_factor(spec: Spec, mesh: Mesh) -> int:
    """How many ways a leaf with ``spec`` is split: the product of the sizes
    of the axes that shard it."""
    n = 1
    for entry in spec:
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            n *= mesh[a]
    return n


def per_chip_bytes(leaves: Mapping[str, Tuple[int, int]], specs: Mapping[str, Spec],
                   mesh: Mesh) -> float:
    """``{name: (numel, element size)}`` under ``specs`` -> the bytes one
    chip of ``mesh`` holds: each leaf's bytes over its ``shard_factor``."""
    return float(sum(n * size / shard_factor(specs.get(k, ()), mesh)
                     for k, (n, size) in leaves.items()))


def flat_leaves(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts and lists -> ``{"a/0/b": leaf}``; anything else (a
    tensor, a spec tuple, a host scalar) is a leaf."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_leaves(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(flat_leaves(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out
