"""The first steps of Algorithm 1 in plain PyTorch: the reference that the
timed ``P2PTrainer.step`` is held to.

Each step: every peer's loss and gradient over its rows of the global
batch; error feedback (the residual added back before encoding, and kept
as what the encoding dropped); the exchange's combine on the full graph
(``reference/exchanges/<name>.py``); then the optimizer
(``reference/optimizers/<name>.py``) at the schedule's rate
(``reference/schedules/<name>.py``), each found by the name the cell
gives. Held once on the full graph: every peer steps with the same mix.

The codecs keep the wire format of the system under test: each leaf in
the layout the wire uses (a 4-d convolution weight as (kh, kw, in, out),
a 2-d weight transposed), flattened, zero-padded to whole QSGD buckets,
and the leaves taken in the order ``wire_order`` gives; QSGD's rounding
uniforms are drawn per leaf, shape (peers, buckets, bucket), from the
generator the benchmark hands both sides.

``fault`` plants one of the faults a correctness check must catch, for
measuring what each reads: ``"unchanged"`` (no update), ``"half_batch"``
(each peer's first half of rows only, or of a lone row's tokens), ``"no_exchange"`` (each peer keeps
its own gradient; peer 0's steps the shared copy), ``"altered"`` (one
leaf's mixed gradient scaled by 1.5 where the exchange produces it).
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Optional

import torch

from p2pbench.reference.precision import check

FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")


def wire_order(names) -> List[str]:
    """Leaf names in the wire's order: split at dots, numbers compared as
    numbers and before words."""
    key = lambda n: tuple((0, int(c), "") if c.isdigit() else (1, 0, c) for c in n.split("."))
    return sorted(names, key=key)


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    return t.t() if t.dim() == 2 else t


def _from_wire(t: torch.Tensor, shape) -> torch.Tensor:
    if len(shape) == 4:
        return t.reshape(shape[2], shape[3], shape[1], shape[0]).permute(3, 2, 0, 1).contiguous()
    if len(shape) == 2:
        return t.reshape(shape[1], shape[0]).t().contiguous()
    return t.reshape(shape)


def part(kind: str, name: str):
    """The reference's module for the ``kind`` ("exchanges", "optimizers",
    "schedules") that a cell names ``name``: ``reference/<kind>/<name>.py``."""
    return importlib.import_module(f"p2pbench.reference.{kind}.{name}")


def run_steps(loss_fn: Callable, params: Dict[str, torch.Tensor], batches: List[dict],
              cell: dict, generator: Optional[torch.Generator] = None, *, precision: str = "f32",
              fault: Optional[str] = None) -> dict:
    """Algorithm 1 from ``params`` over ``batches`` (one global batch a
    step, ``peers x rows`` rows each): ``{"losses": [each step's mean of
    the peers' losses], "grad_norms": {leaf: norm of the first step's
    mixed gradient, as the optimizer gets it}, "change_norms": {leaf: norm
    of the params' change over the steps}}``. ``loss_fn(params, batch,
    precision)`` is one peer's loss; ``params`` are not modified."""
    check(precision)
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    P, ex, opt = cell["peers"], cell["exchange"], cell["optimizer"]
    codec, optimizer = part("exchanges", ex["name"]), part("optimizers", opt["name"])
    lr_at = part("schedules", cell["schedule"]["name"]).rate(cell["schedule"])
    p = {k: v.detach().clone() for k, v in params.items()}
    names = wire_order(p)
    st = {k: optimizer.zero_state(v) for k, v in p.items()}
    ef = {k: torch.zeros((P, *v.shape), device=v.device) for k, v in p.items()} if ex.get("ef") else None
    out = {"losses": [], "grad_norms": {}, "change_norms": {}}
    altered = names[len(names) // 2]
    for t, batch in enumerate(batches):
        losses, grads = [], []
        for r in range(P):
            rows = {k: v.reshape(P, -1, *v.shape[1:])[r] for k, v in batch.items()}
            if fault == "half_batch":  # rows, or a single row's tokens, halved
                dim = 0 if next(iter(rows.values())).shape[0] > 1 else 1
                rows = {k: v.narrow(dim, 0, v.shape[dim] // 2) for k, v in rows.items()}
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            loss = loss_fn(leaves, rows, precision)
            gs = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
            losses.append(loss.item())
            grads.append({k: torch.zeros_like(p[k]) if g is None else g for k, g in zip(names, gs)})
            del leaves, loss, gs
        out["losses"].append(sum(losses) / P)
        with torch.no_grad():
            mixed = {}
            for k in names:
                bank = torch.stack([g.pop(k) for g in grads])
                if ef is not None:
                    bank = bank + ef[k]
                flat = torch.stack([_to_wire(row).reshape(-1) for row in bank])
                avg, own = codec.combine(flat, ex, generator)
                if fault == "no_exchange":
                    avg = own[0]
                if ef is not None:
                    ef[k] = bank - torch.stack([_from_wire(row, bank.shape[1:]) for row in own])
                g = _from_wire(avg, p[k].shape)
                if fault == "altered" and k == altered:
                    g = g * 1.5
                mixed[k] = g
                del bank, flat, own
            if t == 0:  # as the optimizer's state holds it: none after no update
                out["grad_norms"] = {k: 0.0 if fault == "unchanged" else
                                     float(torch.linalg.vector_norm(g)) for k, g in mixed.items()}
            if fault != "unchanged":
                lr = lr_at(t)
                for k in names:
                    step, st[k] = optimizer.update(mixed.pop(k), st[k], lr, t + 1, opt)
                    p[k] -= step
    with torch.no_grad():
        out["change_norms"] = {k: float(torch.linalg.vector_norm(p[k] - params[k].detach()))
                               for k in names}
    return out
