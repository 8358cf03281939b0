"""Counting mode of the port's dry run: FLOPs, bytes and peak live bytes of
eager PyTorch work. The twin of the reference's ``repro/launch/hlo_analysis.py``,
which reads the same quantities from compiled HLO text; PyTorch has no HLO,
so this module counts the ops as they are dispatched.

``OpCount`` is a ``TorchDispatchMode``. Inside it every op that reaches
the dispatcher is seen once, below autograd and the ``torch.func``
transforms, on plain tensors, so a remat recompute or a vmapped peer
dimension is counted as it runs: there are no loops whose trip counts need
recovering. Composite ops are counted as the ops they are made of, also
under ``torch.inference_mode()``, where they reach the mode whole. It records

* ``flops``: 2 |out| K of every matrix product and convolution, forward and
  backward (``mm``, ``addmm``, ``bmm``, ``baddbmm``, the convolutions and
  ``convolution_backward``; ``torch.utils.flop_counter``'s formulas), the
  reference's rule, plus each hand-written kernel's FLOPs;
* ``dot_bytes``: the operands and results of those ops, plus each kernel's
  bytes: the reference's ``dot_bytes``, a lower bound on device traffic;
* ``op_bytes``: the tensor inputs and outputs of every op that moves data
  (views and ``empty`` allocations move none). Eager PyTorch runs each op
  as its own pass over device memory, so this is the port's unfused
  traffic;
* ``peak``: the most bytes live at once, tracked per storage (views count
  once): a storage is added when an op allocates it, rounded up to the
  CUDA caching allocator's 512-byte blocks, and taken off when it is
  freed. Tensors that exist before the count (a step's state and batch)
  are added with :meth:`OpCount.track`;
* ``peak_parts``: what was live at the peak, as ``{(the op that allocated
  it, or "argument", block bytes): storages}``; :meth:`OpCount.peak_top`
  lists its largest shares;
* each kernel's calls, FLOPs and bytes (``kernels``), which its wrapper
  reports through ``kernels.build.charge`` from the cost function beside
  the kernel (``flash_attention_cost``, ``ssd_scan_cost``, ...): after a
  launch on the card, in place of one on the meta device.

Only tensors off the CPU count. The same step on the card and on the meta
device dispatches the same ops on the same shapes, so the two counts agree
exactly; ``launch/dryrun.py`` runs the port's steps on meta under it.
"""
from __future__ import annotations

import functools
import weakref
from collections import Counter
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import build

aten = torch.ops.aten
ALLOC_BLOCK = 512  # bytes: the CUDA caching allocator rounds every block up to this
# the matrix products and convolutions, forward and backward
MATMUL_OPS = frozenset({
    aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution, aten._convolution,
    aten.convolution_backward,
})
# ops that allocate but move no data
_NO_TRAFFIC = frozenset({
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
})


def block_bytes(nbytes: int) -> int:
    """``nbytes`` as the CUDA caching allocator hands it out: rounded up to
    whole 512-byte blocks (0 stays 0)."""
    return -(-int(nbytes) // ALLOC_BLOCK) * ALLOC_BLOCK


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors in nested lists, tuples and dicts (an op's arguments and
    results, a state), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _on_device(t: torch.Tensor) -> bool:
    return t.device.type != "cpu"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@functools.lru_cache(maxsize=None)
def _kind(func) -> Tuple[bool, bool, bool]:
    """(composite, moves data, a matrix product) of an op: composite ops
    are counted as the ops they are made of; views (results that alias an
    input without writing it) and ``empty`` allocations move no data."""
    composite = func.has_kernel_for_dispatch_key(torch._C.DispatchKey.CompositeImplicitAutograd)
    view = any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)
    packet = func.overloadpacket
    return composite, not view and packet not in _NO_TRAFFIC, packet in MATMUL_OPS


class OpCount(TorchDispatchMode):
    """FLOPs, bytes and peak live bytes of the ops run inside it (module
    docstring). Use as a context manager; read the fields or :meth:`summary`
    after."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.dot_bytes = 0
        self.op_bytes = 0
        self.ops = 0
        self.kernels: Dict[str, List[float]] = {}  # name -> [calls, FLOPs, bytes]
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, Tuple[str, int]] = {}  # id of a live storage -> its part
        self._live_parts: Counter = Counter()  # (op, block bytes) -> live storages
        self._peak_parts: Dict[Tuple[str, int], int] = {}
        self._at_peak = False  # live == peak since the last allocation: parts not yet copied
        self._depth = 0

    # -- live storages ------------------------------------------------------

    def _add(self, storage, op: str = "argument") -> int:
        key = id(storage)
        if key in self._storages:
            return 0
        part = (op, block_bytes(storage.nbytes()))
        self._storages[key] = part
        self._live_parts[part] += 1
        weakref.finalize(storage, self._free, key)
        self.live += part[1]
        if self.live > self.peak:
            self.peak, self._at_peak = self.live, True
        return part[1]

    def _free(self, key: int) -> None:
        part = self._storages.pop(key, None)
        if part is None:
            return
        if self._at_peak:  # leaving a new peak: what is live is what it held
            self._peak_parts, self._at_peak = +self._live_parts, False
        self._live_parts[part] -= 1
        self.live -= part[1]

    @property
    def peak_parts(self) -> Dict[Tuple[str, int], int]:
        """``{(op, block bytes): storages}`` live at the peak."""
        return dict(+self._live_parts if self._at_peak else self._peak_parts)

    def peak_top(self, n: int = 5) -> List[Dict[str, Any]]:
        """The ``n`` largest shares of the peak, each an op's storages of
        one size: ``{"op", "block_bytes", "storages", "bytes"}``, largest
        first."""
        parts = sorted(self.peak_parts.items(), key=lambda kv: -kv[0][1] * kv[1])[:n]
        return [{"op": op, "block_bytes": size, "storages": k, "bytes": size * k}
                for (op, size), k in parts]

    def track(self, *trees: Any) -> int:
        """Count the storages of the tensors in ``trees`` (dicts, lists, ...)
        as live from now on, each once; returns the bytes added."""
        return sum(self._add(t.untyped_storage()) for t in _tensors(trees) if _on_device(t))

    # -- kernels ------------------------------------------------------------

    def charge(self, name: str, flops: float, nbytes: float) -> None:
        """One hand-written kernel call (``kernels.build.charge``)."""
        calls = self.kernels.setdefault(name, [0, 0, 0])
        calls[0] += 1
        calls[1] += flops
        calls[2] += nbytes
        self.flops += flops
        self.dot_bytes += nbytes
        self.op_bytes += nbytes

    def __enter__(self):
        if not self._depth:
            build.SINKS.append(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            build.SINKS.remove(self)
        return super().__exit__(*exc)

    # -- ops ----------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        composite, moves, matmul = _kind(func)
        if composite:
            # Under torch.inference_mode() composite ops (linear, einsum, to)
            # reach the mode whole; count the ops they are made of, as
            # autograd's decomposition shows them outside it.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins = [t for t in _tensors((args, kwargs)) if _on_device(t)]
        outs = [t for t in _tensors(out) if _on_device(t)]
        if not outs and not ins:
            return out
        self.ops += 1
        moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if matmul:
            self.flops += int(flop_registry[func.overloadpacket](*args, **kwargs, out_val=out))
            self.dot_bytes += moved
        if moves:
            self.op_bytes += moved
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            storage = t.untyped_storage()
            if id(storage) not in held:
                self._add(storage, func.overloadpacket.__name__)
        return out

    def summary(self) -> Dict[str, Any]:
        return {
            "flops": self.flops, "dot_bytes": self.dot_bytes, "op_bytes": self.op_bytes,
            "ops": self.ops, "peak_bytes": self.peak,
            "kernels": {k: {"calls": v[0], "flops": v[1], "bytes": v[2]}
                        for k, v in sorted(self.kernels.items())},
        }
