"""ShardPlan — contiguous gradient sharding, the unit of sharded exchange.

The port of the reference's ``repro/core/shard.py``. SPIRT partitions model
updates so each peer aggregates only its shard; LambdaML shows
scatter-reduce aggregation is the winning pattern for serverless training.
Both need one primitive: a deterministic mapping between a gradient dict
and ``P`` equal-size contiguous shards. That mapping is a
:class:`ShardPlan`:

* **flatten** — the leaves, in JAX leaf order (``convert.jax_order``) and
  each in the reference's layout (HWIO convolutions, ``(din, dout)`` linear
  weights), are raveled, cast to a common buffer dtype (the promotion of
  all leaf dtypes) and concatenated into one contiguous buffer,
  zero-padded to a multiple of ``num_shards``. The buffer is the
  reference's element for element, so shard boundaries, shard bytes and
  wire accounting are the reference's.
* **shard** — the padded buffer splits into ``num_shards`` equal
  contiguous rows, ``shards[i] = buffer[i*S : (i+1)*S]``; shard ``i`` is
  owned by peer ``i`` under the sharded exchange protocols.
* **unflatten** — the exact inverse: each leaf's ``[offset, offset+size)``
  range is sliced out, reshaped, put back in the port's layout and cast to
  the leaf's dtype.

Every method takes ``lead`` leading dimensions (the device step's stacked
peer bank) and keeps them in front. The plan holds shapes only, so it can
be built from tensors on the ``meta`` device. With more shards than
parameters (``P > total``) the trailing shards are pure padding,
exchanged, aggregated, and dropped by ``unflatten``.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.convert import jax_order, to_jax_layout, to_torch_layout


@dataclass(frozen=True)
class ShardPlan:
    """Static metadata mapping one ``{name: tensor}`` dict <-> ``num_shards``
    contiguous shards."""

    names: Tuple[str, ...]  # leaves in JAX leaf order
    shapes: Tuple[Tuple[int, ...], ...]  # each leaf's shape in the reference's layout
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]  # element offset of each leaf in the buffer
    total: int  # unpadded element count across all leaves
    num_shards: int
    shard_size: int  # elements per shard (padded; equal for every shard)
    buffer_dtype: torch.dtype  # promoted dtype every leaf roundtrips through

    # -- construction --------------------------------------------------------
    @classmethod
    def for_tree(cls, tree_like: Mapping[str, torch.Tensor], num_shards: int, *,
                 lead: int = 0) -> "ShardPlan":
        """Build a plan from a dict of tensors (``lead`` leading dimensions
        of each are not part of the leaf)."""
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        names = tuple(jax_order(tree_like))
        shapes = tuple(
            tuple(int(d) for d in to_jax_layout(tree_like[n], lead=lead).shape[lead:])
            for n in names
        )
        dtypes = tuple(tree_like[n].dtype for n in names)
        offsets, off = [], 0
        for s in shapes:
            offsets.append(off)
            off += int(np.prod(s)) if s else 1
        buffer_dtype = functools.reduce(torch.promote_types, dtypes) if dtypes else torch.float32
        return cls(
            names=names,
            shapes=shapes,
            dtypes=dtypes,
            offsets=tuple(offsets),
            total=off,
            num_shards=int(num_shards),
            shard_size=math.ceil(off / num_shards) if off else 0,
            buffer_dtype=buffer_dtype,
        )

    # -- derived sizes -------------------------------------------------------
    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(int(np.prod(s)) if s else 1 for s in self.shapes)

    @property
    def padded_size(self) -> int:
        return self.num_shards * self.shard_size

    @property
    def pad(self) -> int:
        """Zero elements appended so every shard is exactly ``shard_size``."""
        return self.padded_size - self.total

    def shard_slice(self, i: int) -> Tuple[int, int]:
        """Element range ``[start, stop)`` of shard ``i`` in the buffer."""
        if not 0 <= i < self.num_shards:
            raise IndexError(f"shard {i} out of range [0, {self.num_shards})")
        return i * self.shard_size, (i + 1) * self.shard_size

    def shard_bytes(self, wire_dtype: Optional[torch.dtype] = None) -> int:
        """Bytes of one shard on the wire — the sharded per-edge payload and
        the figure aggregator memory is sized from (O(model / P))."""
        dt = self.buffer_dtype if wire_dtype is None else wire_dtype
        return self.shard_size * torch.empty((), dtype=dt).element_size()

    # -- flatten / shard -----------------------------------------------------
    def flatten(self, tree: Mapping[str, torch.Tensor], *, lead: int = 0) -> torch.Tensor:
        """Dict -> one contiguous padded buffer (``buffer_dtype``), shaped
        ``(*lead_dims, padded_size)``."""
        if len(tree) != len(self.names):
            raise ValueError(
                f"tree has {len(tree)} leaves, plan was built for {len(self.names)}"
            )
        if not self.names:
            return torch.zeros((self.padded_size,), dtype=self.buffer_dtype)
        first = tree[self.names[0]]
        lead_shape = tuple(first.shape[:lead])
        flat = torch.cat([
            to_jax_layout(tree[n], lead=lead).reshape(*lead_shape, -1).to(self.buffer_dtype)
            for n in self.names
        ], dim=lead)
        return F.pad(flat, (0, self.pad)) if self.pad else flat

    def shards(self, tree: Mapping[str, torch.Tensor], *, lead: int = 0) -> torch.Tensor:
        """Dict -> ``(*lead_dims, num_shards, shard_size)``; row ``i`` is
        shard ``i``."""
        flat = self.flatten(tree, lead=lead)
        return flat.reshape(*flat.shape[:lead], self.num_shards, self.shard_size)

    # -- unflatten -----------------------------------------------------------
    def unflatten(self, buffer: torch.Tensor, *, lead: int = 0) -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`flatten` / :meth:`shards`.

        Accepts the padded buffer or the ``(num_shards, shard_size)`` stack
        (after ``lead`` leading dimensions); padding is dropped, every leaf
        is reshaped, put in the port's layout and cast back to its dtype."""
        lead_shape = tuple(buffer.shape[:lead])
        buf = buffer.reshape(*lead_shape, -1)
        if buf.shape[-1] != self.padded_size:
            raise ValueError(
                f"buffer has {buf.shape[-1]} elements, plan expects "
                f"{self.padded_size} (= {self.num_shards} x {self.shard_size})"
            )
        return {
            n: to_torch_layout(
                buf[..., off:off + size].reshape((*lead_shape, *shape)), lead=lead
            ).to(dtype)
            for n, shape, dtype, off, size in zip(
                self.names, self.shapes, self.dtypes, self.offsets, self.sizes
            )
        }

    def describe(self) -> str:
        return (
            f"ShardPlan(P={self.num_shards}, {self.total} elems -> "
            f"{self.shard_size}/shard (+{self.pad} pad), "
            f"buffer={str(self.buffer_dtype).replace('torch.', '')}, "
            f"{self.shard_bytes()} B/shard)"
        )
