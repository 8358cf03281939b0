"""The H100 dry run: every (arch x input shape) combination of the
reference's dry run, worked out on the meta device. The twin of the
reference's ``repro/launch/dryrun.py``, which lowers and compiles each
combination on 256 or 512 placeholder TPU devices and reads FLOPs and bytes
from the HLO.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.json]

Each combination runs the port's own step, the functions the card runs,
on ``meta`` tensors (shapes and dtypes, no data) under
``launch.op_analysis.OpCount``: the train step (``train.build_train_step``:
Adam, ``allgather_mean``, the dense MoE dispatch, the reference's
defaults), the prefill forward (``models.forward`` under
``torch.inference_mode()``), or one ``models.decode_step`` over
``models.init_decode_state``. The kernel wrappers take their CUDA route on
meta tensors, allocating what the kernels would and charging their cost
functions, without a build or a launch. ``topology_for`` keeps the
reference's peer count on its production mesh, so a step is the work of
the reference's whole mesh, stacked on one card.

Each record keeps the reference's keys. On one card ``chips`` is 1 and
``collective_bytes`` 0 (the stacked peers' exchange is a reduction on the
device, counted in the op bytes); ``hlo_flops`` and ``hlo_bytes`` are the
count's matrix-product FLOPs and bytes with the kernels' (the reference's
``hlo_analysis`` quantities); the terms are priced at ``launch.mesh``'s H100
constants; ``memory`` holds the state and batch (``argument_bytes``), what
the step leaves beside them (``output_bytes``), and the peak of live bytes.
Added: ``op_bytes`` (every op's inputs and outputs: eager PyTorch's
traffic), ``fits`` (peak within the card's 80 GB),
``per_chip_argument_bytes`` (what one chip of the reference's layout would
hold of the arguments, by ``launch.sharding``'s rules) and ``regime``
(the reference's layout for the arch, ``serverless`` or ``fsdp``).

No step reads a tensor's values on the host: the capacity MoE dispatch
sizes its slots from shapes (C = ceil(k T / E x factor)) and the exchanges
select and scatter in shapes fixed by k. ``--exchange qsgd`` is refused:
its codec draws uniforms from a generator on the state's device, and the
meta device has no generator.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import convert, models
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.p2p import Topology, TrainState
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import (
    HBM_BW,
    HBM_BYTES,
    PEAK_FLOPS_BF16,
    make_production_mesh,
)
from repro_torch.launch.op_analysis import OpCount
from repro_torch.optim import adam, sgd

# the reference's ASSIGNED_ARCHS, in its order
ASSIGNED_ARCHS = ("mamba2-370m", "granite-moe-3b-a800m", "qwen2.5-3b", "dbrx-132b",
                  "internvl2-26b", "gemma2-2b", "whisper-base", "moonshot-v1-16b-a3b",
                  "starcoder2-3b", "zamba2-1.2b")

# (arch, shape) pairs that are skipped by design
SKIPS = {
    ("whisper-base", "long_500k"): "enc-dec audio decoder; 500k autoregressive decode is meaningless",
}

META = torch.device("meta")


class SkipCombo(Exception):
    pass


def peer_axes(cfg: ModelConfig, mesh) -> Tuple[str, ...]:
    """The reference's peer axes: ("pod", "data") or ("data",) for a
    non-FSDP arch, ("pod",) or none for an FSDP one."""
    if cfg.fsdp:
        return ("pod",) if "pod" in mesh else ()
    return ("pod", "data") if "pod" in mesh else ("data",)


def peer_count(cfg: ModelConfig, mesh) -> int:
    """The peers of the reference's layout: the product of its peer axes."""
    return math.prod(mesh[a] for a in peer_axes(cfg, mesh))


def topology_for(
    cfg: ModelConfig, mesh, *,
    exchange: str = "allgather_mean",
    exchange_dtype: str = "float32",
    cast_params_once: bool = False,
) -> Topology:
    """The reference's topology for ``cfg`` on ``mesh``, in the fields that
    mean something on one card (the peers are ``peer_count``, the regime
    ``regime``)."""
    return Topology(exchange=exchange, exchange_dtype=exchange_dtype,
                    cast_params_once=cast_params_once)


def regime(cfg: ModelConfig) -> str:
    """The reference's layout for ``cfg``: "serverless" (regime A) fans each
    peer's micro-batches out over the "model" axis, "fsdp" (regime B) uses
    that axis for tensor parallelism. On one card it decides only the peer
    count and ``per_chip_argument_bytes``."""
    return "fsdp" if cfg.fsdp else "serverless"


def cfg_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """serve_window (the SWA serving variant) applies only to long_500k."""
    if shape.name != "long_500k" and cfg.serve_window:
        return dataclasses.replace(cfg, serve_window=0)
    return cfg


# ---------------------------------------------------------------------------
# Counting the port's steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Count:
    """One counted run: the ``OpCount`` and the bytes of what the run took
    (``argument_bytes``) and left beside it (``output_bytes``)."""

    ops: OpCount
    argument_bytes: int
    output_bytes: int


def _count(fn, held):
    """Run ``fn()`` under a fresh ``OpCount`` with the tensors of ``held``
    live from the start -> (Count, fn's result)."""
    c = OpCount()
    with c:
        argument_bytes = c.track(held)
        out = fn()
        after = c.live
    return Count(c, argument_bytes, after - argument_bytes), out


def count_train_step(step, state: TrainState, batch: Dict[str, torch.Tensor]):
    """One call of a train ``step`` (``train.build_train_step``) on ``state``
    and ``batch``, counted -> (Count, the step's (state, metrics)). The same
    call on the card or on meta tensors dispatches the same ops."""
    return _count(lambda: step(state, batch), (state.params, state.opt_state, batch))


def count_forward(model, batch: Dict[str, torch.Tensor], cfg: ModelConfig, **flags):
    """One scoring forward (``models.forward`` under
    ``torch.inference_mode()``), counted -> (Count, (logits, aux)). The
    model's parameters are arguments."""
    def run():
        with torch.inference_mode():
            return models.forward(model, batch, cfg, **flags)

    return _count(run, (list(model.parameters()), batch))


def meta_model(cfg: ModelConfig):
    """The model's skeleton on the meta device, as the card's serving path
    builds it (f32 params, no grad)."""
    return models.init_model(cfg, generator=None, device=META).requires_grad_(False)


def meta_batch(cfg: ModelConfig, rows: int, seq: int, *, labels: bool) -> Dict[str, torch.Tensor]:
    """A batch of ``rows`` x ``seq`` int64 tokens (and labels) on meta, with
    whisper's frames and the VLM's patches in bf16, each contiguous."""
    batch = {"tokens": torch.empty((rows, seq), dtype=torch.int64, device=META)}
    if labels:
        batch["labels"] = torch.empty((rows, seq), dtype=torch.int64, device=META)
    if cfg.family == "encdec":
        batch["frames"] = torch.empty((rows, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
                                      device=META)
    if cfg.family == "vlm":
        batch["patches"] = torch.empty((rows, cfg.vision_tokens, cfg.d_model),
                                       dtype=torch.bfloat16, device=META)
    return batch


def on_meta(tree):
    """Nested dicts and lists of tensors -> the same shapes and dtypes on the
    meta device, contiguous: a card run's inputs for its meta count."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=META)
    if isinstance(tree, dict):
        return {k: on_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(on_meta(v) for v in tree)
    return tree


def meta_train_state(cfg: ModelConfig, opt) -> TrainState:
    params = {k: p.detach() for k, p in meta_model(cfg).named_parameters()}
    return TrainState(params=params, opt_state=opt.init(params), step=0, key=None)


def meta_train(cfg: ModelConfig, peers: int, rows: int, seq: int, *, optimizer: str = "adam",
               topo: Optional[Topology] = None, moe_dispatch: str = "dense",
               batch: Optional[Dict] = None) -> Tuple[Count, TrainState, Dict]:
    """One train step of ``peers`` x ``rows`` x ``seq`` tokens on meta (on
    ``batch``, meta tensors, where given) -> (Count, the state it started
    from, the batch)."""
    from repro_torch.train import build_train_step

    opt = adam() if optimizer == "adam" else sgd(momentum=0.9)
    state = meta_train_state(cfg, opt)
    if batch is None:
        batch = meta_batch(cfg, peers * rows, seq, labels=True)
    step = build_train_step(cfg, opt, topo or Topology(), peers, lambda s: 1e-3,
                            moe_dispatch=moe_dispatch, device=META)
    count, _ = count_train_step(step, state, batch)
    return count, state, batch


def meta_decode(cfg: ModelConfig, batch: int, seq_len: int, *, moe_dispatch: str = "dense"):
    """One decode step of ``batch`` tokens over a fresh decode state of
    ``seq_len`` positions on meta -> (Count, the model, the state)."""
    model = meta_model(cfg)
    state = models.init_decode_state(cfg, batch, seq_len, device=META)
    token = torch.empty((batch, 1), dtype=torch.int64, device=META)

    def run():
        with torch.inference_mode():
            return models.decode_step(model, state, token, cfg, moe_dispatch=moe_dispatch)

    count, _ = _count(run, (list(model.parameters()), state, token))
    return count, model, state


# ---------------------------------------------------------------------------
# One combination
# ---------------------------------------------------------------------------


def _params_chip_bytes(params: Dict[str, torch.Tensor], cfg: ModelConfig, mesh) -> float:
    shapes = convert.lm_jax_shapes({k: tuple(p.shape) for k, p in params.items()}, cfg)
    specs = SH.param_specs(shapes, cfg, mesh)
    size = next(iter(params.values())).element_size()
    return float(sum(math.prod(s) * size / SH.shard_factor(specs[k], mesh)
                     for k, s in shapes.items()))


def _leaves_chip_bytes(tree, specs, mesh) -> float:
    leaves = {k: t for k, t in SH.flat_leaves(tree).items() if isinstance(t, torch.Tensor)}
    return SH.per_chip_bytes({k: (t.numel(), t.element_size()) for k, t in leaves.items()},
                             SH.flat_leaves(specs), mesh)


def lower_one(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    exchange: str = "allgather_mean",
    exchange_dtype: str = "float32",
    cast_params_once: bool = False,
    moe_dispatch: str = "dense",
    optimizer: str = "adam",
) -> Tuple[Count, Dict[str, Any]]:
    """Work out one combination on the meta device -> (Count, meta): the
    reference's ``lower_one``, with the port's counted step in place of the
    lowered and compiled program. ``meta`` carries the record's
    identifying keys and ``per_chip_argument_bytes``."""
    if (arch, shape_name) in SKIPS:
        raise SkipCombo(SKIPS[(arch, shape_name)])
    shape = SHAPES[shape_name]
    cfg = cfg_for_shape(get_config(arch), shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    topo = topology_for(cfg, mesh, exchange=exchange, exchange_dtype=exchange_dtype,
                        cast_params_once=cast_params_once)
    if shape.mode == "train" and topo.protocol().requires_key:
        raise ValueError(f"exchange {exchange!r} draws random numbers, from a torch.Generator "
                         "on the state's device, and the meta device has none")
    peers = peer_count(cfg, mesh)
    rules = SH.activation_rules(cfg, shape, mesh, peer_axes=peer_axes(cfg, mesh))
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "decode":
        count, model, state = meta_decode(cfg, B, S, moe_dispatch=moe_dispatch)
        params = dict(model.named_parameters())
        chip = (_params_chip_bytes(params, cfg, mesh)
                + _leaves_chip_bytes(state, SH.decode_state_specs(state, cfg, mesh, rules), mesh)
                + B * 8 / SH.shard_factor(SH.sanitize_spec(
                    (B, 1), (rules["batch"],) if rules["batch"] else (), mesh), mesh))
    else:
        batch_shapes, batch_specs = SH.batch_specs(cfg, shape, mesh, rules)
        chip = SH.per_chip_bytes(
            {k: (math.prod(s), torch.empty((), dtype=dt).element_size())
             for k, (s, dt) in batch_shapes.items()}, batch_specs, mesh)
        if shape.mode == "train":
            count, state, _ = meta_train(cfg, peers, B // peers, S, optimizer=optimizer, topo=topo,
                                         moe_dispatch=moe_dispatch)
            copies = sum(isinstance(v, dict) for v in state.opt_state.values()) or 1
            chip += (1 + copies) * _params_chip_bytes(state.params, cfg, mesh)
        else:
            model = meta_model(cfg)
            count, _ = count_forward(model, meta_batch(cfg, B, S, labels=False), cfg,
                                     moe_dispatch=moe_dispatch)
            chip += _params_chip_bytes(dict(model.named_parameters()), cfg, mesh)
    meta = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.values()),
        "mode": shape.mode,
        "exchange": exchange if shape.mode == "train" else "-",
        "peers": peers,
        "regime": regime(cfg),
        "moe_dispatch": moe_dispatch if cfg.num_experts else "-",
        "per_chip_argument_bytes": chip,
    }
    return count, meta


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 N D for train (forward and backward), 2 N D for inference, with N
    the active params and D the tokens: the reference's MODEL_FLOPS."""
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode" else 1)
    return float((6 if shape.mode == "train" else 2) * cfg.active_param_count() * tokens)


def roofline(count: Count, cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The reference's roofline fields from a count, priced at the H100's
    constants on one chip."""
    c = count.ops
    terms = {"compute": c.flops / PEAK_FLOPS_BF16, "memory": c.dot_bytes / HBM_BW,
             "collective": 0.0}
    mf = model_flops(cfg, shape)
    return {
        "chips": 1,
        "hlo_flops": float(c.flops),
        "hlo_bytes": float(c.dot_bytes),
        "op_bytes": float(c.op_bytes),
        "collective_bytes": 0.0,
        "collectives": {},
        "terms_s": terms,
        "dominant": max(terms, key=terms.get),
        "model_flops": mf,
        "useful_flops_ratio": mf / c.flops if c.flops else 0.0,
        "kernels": c.summary()["kernels"],
        "memory": {
            "argument_bytes": count.argument_bytes,
            "output_bytes": count.output_bytes,
            "temp_bytes": c.peak - count.argument_bytes,
            "peak_bytes": c.peak,
            "peak_top": c.peak_top(),
        },
        "fits": c.peak <= HBM_BYTES,
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def run_one(arch: str, shape_name: str, *, multi_pod: bool, verbose: bool = True,
            **kw) -> Optional[Dict[str, Any]]:
    t0 = time.time()
    try:
        count, meta = lower_one(arch, shape_name, multi_pod=multi_pod, **kw)
    except SkipCombo as e:
        if verbose:
            print(f"SKIP {arch} x {shape_name}: {e}")
        return {"arch": arch, "shape": shape_name, "skipped": str(e)}
    cfg = cfg_for_shape(get_config(arch), SHAPES[shape_name])
    rf = roofline(count, cfg, SHAPES[shape_name])
    rec = {**meta, **rf, "lower_compile_s": round(time.time() - t0, 1)}
    if verbose:
        mem = rf["memory"]
        top = mem["peak_top"][0]
        print(
            f"OK {arch} x {shape_name} [{meta['mesh']} on 1 H100] peers={meta['peers']} "
            f"flops={rf['hlo_flops']:.3e} bytes={rf['hlo_bytes']:.3e} "
            f"op_bytes={rf['op_bytes']:.3e} dom={rf['dominant']} "
            f"useful={rf['useful_flops_ratio']:.2f} "
            f"mem(arg={mem['argument_bytes'] / 1e9:.2f}GB peak={mem['peak_bytes'] / 1e9:.2f}GB "
            f"fits={rf['fits']} per-chip arg={meta['per_chip_argument_bytes'] / 1e9:.2f}GB) "
            f"peak's largest share={top['storages']} x {top['block_bytes'] / 2**30:.4f}GiB "
            f"from {top['op']} t={rec['lower_compile_s']}s"
        )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--exchange", default="allgather_mean")
    ap.add_argument("--exchange-dtype", default="float32")
    ap.add_argument("--cast-params", action="store_true")
    ap.add_argument("--moe-dispatch", default="dense")
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    combos = []
    if args.all:
        for a in ASSIGNED_ARCHS:
            for s in SHAPES:
                combos.append((a, s))
    else:
        combos.append((args.arch, args.shape))

    records = []
    failed = []
    for a, s in combos:
        try:
            rec = run_one(
                a, s,
                multi_pod=args.multi_pod,
                exchange=args.exchange,
                exchange_dtype=args.exchange_dtype,
                cast_params_once=args.cast_params,
                moe_dispatch=args.moe_dispatch,
                optimizer=args.optimizer,
            )
            records.append(rec)
        except Exception as e:
            failed.append((a, s, repr(e)))
            print(f"FAIL {a} x {s}: {e!r}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1, default=str)
    print(f"\n{len([r for r in records if 'skipped' not in r])} ok, "
          f"{len([r for r in records if 'skipped' in r])} skipped, {len(failed)} failed")
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
