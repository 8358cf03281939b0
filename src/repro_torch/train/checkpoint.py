"""Checkpoints of the port: npz files keyed by path, plus a JSON sidecar,
in the formats of the reference's ``repro/train/checkpoint.py``, so that a
checkpoint crosses between the packages in both directions.

Formats are versioned through the ``format`` metadata key:

* (absent) / ``"pytree/v1"`` — a bare tree, typically params only (what
  :func:`save` writes).
* ``"train-state/v2"`` — a full :class:`~repro_torch.core.p2p.TrainState`
  (params, optimizer state, step, key, the async mailbox, the EF residual
  bank), written by :func:`save_state`. :func:`restore_state` reads
  either: a v1 params-only checkpoint restores into ``like.params`` and
  keeps the rest as in ``like``.

The npz keys are the reference's ``_flatten`` paths: dict keys and list
indices joined by ``/``, a TrainState's fields by name (``params/…``,
``opt_state/…``, ``step``, ``key``, ``mailbox/…``, ``ef/…``). Given the
model's ``cfg``, a model's params are written in the reference's layout
(``convert.lm_to_jax`` for an LM: the stacked ``stack``/``tail`` layout;
``convert.to_jax`` for a CNN) and so is every params-shaped dict of the
state: Adam's ``mu`` and ``nu``, SGD's momentum, the EF bank (P, …) and the
mailbox ring (K, P, …). Without ``cfg`` a tree is written as it stands.

The key (ROADMAP.md, reference behaviour 22): the reference's is a JAX
PRNG key, the port's a ``torch.Generator``, and JAX streams cannot be
reproduced (behaviour 2). The port writes ``key`` as the reference's
(2,) uint32 raw key, ``jax.random.PRNGKey(s)``'s bits for a generator
seeded with s, and the generator's whole state under the extra entry
``torch_generator_state``, which the reference's restore ignores. Its
own restore takes the generator state back where the entry fits the
generator, and otherwise (a reference checkpoint) seeds the generator
from the key's 64 bits.

A :class:`~repro_torch.core.p2p.PeerBank` state (a sparse overlay or
``async``) is written as peer 0's copy, what the reference's replicated
arrays hold (behaviour 1), and restored into every peer's row.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.core.p2p import PeerBank, as_train_state, peer_bank, peer_row

V1_FORMAT = "pytree/v1"
STATE_FORMAT = "train-state/v2"
GENERATOR_STATE = "torch_generator_state"
_OPTIONAL = ("mailbox", "ef")
_LEAD = {"params": 0, "opt_state": 0, "ef": 1, "mailbox": 2}  # a field's leading bank dims


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"


def _read_meta(path: str) -> dict:
    mp = _meta_path(path)
    if not os.path.exists(mp):
        return {}
    with open(mp) as f:
        return json.load(f)


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


# ---------------------------------------------------------------------------
# Trees <-> {path: numpy array}
# ---------------------------------------------------------------------------


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` as the reference's ``_flatten`` keys a tree of the
    same structure (None is an empty subtree)."""
    if tree is None:
        return {}
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def _like_leaf(arr: np.ndarray, leaf):
    """``arr`` as ``leaf``'s kind: a tensor on its device in its dtype, a
    Python number, or a numpy array of its dtype."""
    if torch.is_tensor(leaf):
        return torch.from_numpy(np.array(arr)).to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr)
    return np.asarray(arr, dtype=np.asarray(leaf).dtype)


def _rebuild(like, get, prefix: str = ""):
    """``like``'s structure with each leaf from ``get(path, leaf)``."""
    if like is None:
        return None
    if isinstance(like, Mapping):
        kind = type(like) if isinstance(like, PeerBank) else dict
        return kind({k: _rebuild(v, get, f"{prefix}{k}/") for k, v in like.items()})
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, get, f"{prefix}{i}/") for i, v in enumerate(like))
    return get(prefix[:-1], like)


def _is_lm(cfg: ModelConfig) -> bool:
    return cfg.family != "cnn"


def _model_to_jax(d: Mapping[str, torch.Tensor], cfg: ModelConfig, lead: int) -> Dict[str, np.ndarray]:
    """A params-shaped dict (``lead`` leading bank dims) -> the reference's
    ``{path: array}`` in its layout."""
    if not lead:
        return convert.lm_to_jax(d, cfg) if _is_lm(cfg) else convert.to_jax(d)
    if not _is_lm(cfg):
        return {convert.jax_path(k): _to_numpy(convert.to_jax_layout(d[k].detach(), lead))
                for k in convert.jax_order(d)}
    shape = next(iter(d.values())).shape[:lead]
    rows = [convert.lm_to_jax({k: v.reshape(-1, *v.shape[lead:])[i] for k, v in d.items()}, cfg)
            for i in range(int(np.prod(shape)))]
    return {p: np.stack([r[p] for r in rows]).reshape(*shape, *a.shape)
            for p, a in rows[0].items()}


def _model_from_jax(flat: Mapping[str, np.ndarray], cfg: ModelConfig, lead: int,
                    like: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`_model_to_jax`, onto ``like``'s devices and
    dtypes."""
    if not lead:
        d = (convert.lm_from_jax(flat, cfg, device="cpu") if _is_lm(cfg)
             else convert.from_jax(flat, device="cpu"))
    elif not _is_lm(cfg):
        d = {convert.torch_name(p): convert.to_torch_layout(torch.from_numpy(np.array(a)), lead)
             for p, a in flat.items()}
    else:
        shape = next(iter(flat.values())).shape[:lead]
        rows = [convert.lm_from_jax({p: a.reshape(-1, *a.shape[lead:])[i] for p, a in flat.items()},
                                    cfg, device="cpu") for i in range(int(np.prod(shape)))]
        d = {k: torch.stack([r[k] for r in rows]).reshape(*shape, *t.shape)
             for k, t in rows[0].items()}
    return {k: d[k].to(device=t.device, dtype=t.dtype) for k, t in like.items()}


def _field_to_jax(tree, names, cfg, lead: int) -> Dict[str, Any]:
    """One field of a state (params, opt_state, ef, mailbox) -> ``{path:
    leaf}``: each params-shaped dict (keyed by ``names``) in the model's
    layout, other leaves (Adam's step count) as they stand."""
    if isinstance(tree, Mapping) and tree and set(tree) == names:
        return _model_to_jax(tree, cfg, lead)
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update({f"{k}/{p}" if p else str(k): a
                        for p, a in _field_to_jax(v, names, cfg, lead).items()})
        return out
    return _flatten(tree)


def _field_from_jax(like, names, cfg, lead: int, flat, prefix: str = ""):
    """The inverse of :func:`_field_to_jax`, from the field's ``{path:
    array}``, onto ``like``'s structure, devices and dtypes."""
    if isinstance(like, Mapping) and like and set(like) == names:
        sub = {p[len(prefix):]: a for p, a in flat.items() if p.startswith(prefix)}
        return _model_from_jax(sub, cfg, lead, like)
    if isinstance(like, Mapping):
        return {k: _field_from_jax(v, names, cfg, lead, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    return None if like is None else _like_leaf(flat[prefix[:-1]], like)


# ---------------------------------------------------------------------------
# v1: a bare tree
# ---------------------------------------------------------------------------


def _to_flat(tree, cfg: Optional[ModelConfig]) -> Dict[str, np.ndarray]:
    if cfg is not None:
        return _model_to_jax(tree, cfg, 0)
    return {k: _to_numpy(v) for k, v in _flatten(tree).items()}


def _write(path: str, flat: Dict[str, np.ndarray], meta: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(_npz_path(path), **flat)
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f)


def _treedef_repr(flat: Mapping[str, Any]) -> str:
    return f"repro_torch {len(flat)} leaves: {', '.join(sorted(flat))}"[:2000]


def save(path: str, tree: Any, *, step: int = 0, extra: Optional[dict] = None,
         cfg: Optional[ModelConfig] = None) -> None:
    """Write ``tree`` (v1). With ``cfg`` the tree is that model's params
    ``{name: tensor}``, written in the reference's layout."""
    flat = _to_flat(tree, cfg)
    _write(path, flat, {"step": step, "treedef": _treedef_repr(flat), "format": V1_FORMAT,
                        **(extra or {})})


def _check(npz, want: Mapping[str, Any]) -> None:
    """The reference's errors for keys ``want`` (``{path: leaf}``, a leaf a
    tensor on any device, an array or a number) that the file lacks or
    holds in another shape."""
    missing = set(want) - set(npz.files)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
    for key, leaf in want.items():
        shape, like = npz[key].shape, tuple(leaf.shape) if torch.is_tensor(leaf) else np.shape(leaf)
        if shape != like:
            raise ValueError(f"{key}: shape {shape} != {like}")


def restore(path: str, like: Any, *, cfg: Optional[ModelConfig] = None,
            prefix: str = "") -> Tuple[Any, dict]:
    """Restore into the structure of ``like`` (shapes must match; each leaf
    takes ``like``'s device and dtype). With ``cfg``, ``like`` is that
    model's params and the file holds them in the reference's layout,
    under ``prefix`` (``"params/"`` reads a v2 state's params)."""
    want = {prefix + k: v for k, v in _to_flat(like, cfg).items()}
    with np.load(_npz_path(path)) as npz:
        _check(npz, want)
        if cfg is not None:
            flat = {k[len(prefix):]: npz[k] for k in want}
            tree = _model_from_jax(flat, cfg, 0, like)
        else:
            tree = _rebuild(like, lambda p, leaf: _like_leaf(npz[prefix + p], leaf))
    return tree, _read_meta(path)


def restore_params(path: str, like: Mapping[str, torch.Tensor], cfg: ModelConfig):
    """A model's params from a v1 checkpoint or a v2 state's params, the
    port's or the reference's: ``(params, meta)``."""
    meta = _read_meta(path)
    prefix = "params/" if meta.get("format") == STATE_FORMAT else ""
    return restore(path, like, cfg=cfg, prefix=prefix)


# ---------------------------------------------------------------------------
# v2: a TrainState
# ---------------------------------------------------------------------------


def _key_bits(generator: Optional[torch.Generator]) -> np.ndarray:
    """The (2,) uint32 raw key written for ``generator``: the 64 bits of
    its seed, as ``jax.random.PRNGKey(seed)`` holds them (zeros for none)."""
    seed = 0 if generator is None else generator.initial_seed() & (2**64 - 1)
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


def _restore_key(like: Optional[torch.Generator], npz) -> Optional[torch.Generator]:
    """``like`` with the checkpoint's generator state where the file has one
    that fits it, else seeded from the key's bits (reference behaviour 22)."""
    if like is None:
        return None
    if GENERATOR_STATE in npz.files:
        saved = torch.from_numpy(np.array(npz[GENERATOR_STATE]))
        if saved.numel() == like.get_state().numel():
            like.set_state(saved)
            return like
    hi, lo = (int(x) for x in np.asarray(npz["key"], dtype=np.uint32).reshape(-1)[-2:])
    like.manual_seed((hi << 32) | lo)
    return like


def _one_copy(state):
    """A PeerBank state's peer 0 (what the reference's replicated arrays
    hold), or the state as it is; and the bank's peer count (0 for none)."""
    if isinstance(state.params, PeerBank):
        return (state.replace(params=peer_row(state.params, 0),
                              opt_state=peer_row(state.opt_state, 0)),
                state.params.num_peers)
    return state, 0


def _state_to_flat(state, cfg: Optional[ModelConfig]) -> Dict[str, Any]:
    names = set(state.params)
    flat = {}
    for field in ("params", "opt_state", "mailbox", "ef"):
        tree = getattr(state, field)
        if tree is None:
            continue
        sub = (_field_to_jax(tree, names, cfg, _LEAD[field]) if cfg is not None
               else _flatten(tree))
        flat.update({f"{field}/{p}": a for p, a in sub.items()})
    flat["step"] = np.asarray(int(state.step), dtype=np.int32)
    flat["key"] = _key_bits(state.key)
    return flat


def save_state(path: str, state, *, extra: Optional[dict] = None,
               cfg: Optional[ModelConfig] = None) -> None:
    """Save a full TrainState (v2): params, optimizer state, step, key,
    mailbox and EF bank (the last two where set), plus the generator's
    state. With ``cfg`` every params-shaped dict goes in the reference's
    layout."""
    state, _ = _one_copy(as_train_state(state))
    flat = {k: _to_numpy(v) for k, v in _state_to_flat(state, cfg).items()}
    if state.key is not None:
        flat[GENERATOR_STATE] = state.key.get_state().numpy()
    _write(path, flat, {"step": int(state.step), "treedef": _treedef_repr(flat),
                        "format": STATE_FORMAT, **(extra or {})})


def restore_state(path: str, like, *, cfg: Optional[ModelConfig] = None) -> Tuple[Any, dict]:
    """Restore a TrainState from a v2 checkpoint, or params only from v1.

    ``like`` supplies the structure (shapes must match). A v1 checkpoint
    holds bare params: they restore into ``like.params`` and the optimizer
    state, step and key stay as in ``like``. A v2 checkpoint without a
    mailbox or EF bank keeps ``like``'s cold buffers for them."""
    like = as_train_state(like)
    meta = _read_meta(path)
    like, peers = _one_copy(like)
    if meta.get("format") != STATE_FORMAT:
        params, pmeta = restore(path, like.params, cfg=cfg)
        return _rebank(like.replace(params=params), peers), {**meta, **pmeta}
    names = set(like.params)
    with np.load(_npz_path(path)) as npz:
        absent = [f for f in _OPTIONAL if getattr(like, f) is not None
                  and not any(k == f or k.startswith(f + "/") for k in npz.files)]
        core = like.replace(**{f: None for f in absent})

        want = _state_to_flat(core, cfg)
        _check(npz, want)
        fields = {}
        for field in ("params", "opt_state", "mailbox", "ef"):
            tree = getattr(core, field)
            if tree is None:
                continue
            flat = {k[len(field) + 1:]: npz[k] for k in want if k.startswith(field + "/")}
            fields[field] = (_field_from_jax(tree, names, cfg, _LEAD[field], flat) if cfg is not None
                             else _rebuild(tree, lambda p, leaf, flat=flat: _like_leaf(flat[p], leaf)))
        step = _like_leaf(npz["step"], like.step)
        key = _restore_key(like.key, npz)
    return _rebank(like.replace(step=step, key=key, **fields), peers), meta


def _rebank(state, peers: int):
    if not peers:
        return state
    params, opt_state = peer_bank(state.params, state.opt_state, peers)
    return state.replace(params=params, opt_state=opt_state)
