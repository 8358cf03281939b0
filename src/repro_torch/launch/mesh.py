"""The card's constants and the reference's meshes as axis sizes: the twin
of the reference's ``repro/launch/mesh.py``.

The reference builds JAX meshes of TPU v5e chips: (16, 16) = 256 chips with
axes ("data", "model"), or (2, 16, 16) = 512 with ("pod", "data", "model").
The port runs on one H100, where every peer and every Lambda slot is a
stacked dimension of one tensor, so a mesh here is only its axis sizes, a
``{axis: size}`` mapping: the dry run prices the reference's whole mesh
of work on one card, and ``launch/sharding.py`` reads the sizes to say
what one chip of the reference's layout would hold. The reference's
``ICI_BW`` has no twin: one card has no link to price.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM (data sheet): dense bf16 on the tensor cores, fp32
# outside them, HBM3 bandwidth, and the card's memory.
PEAK_FLOPS_BF16 = 989.4e12  # FLOP/s
PEAK_FLOPS_FP32 = 67e12  # FLOP/s
HBM_BW = 3.35e12  # bytes/s
HBM_BYTES = 80e9  # bytes


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh as axis sizes."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def make_host_mesh(data: int = 1, model: int = 1) -> Dict[str, int]:
    """A mesh of ``data`` peers by ``model`` Lambda slots. No device check:
    one card holds every peer and every slot, stacked."""
    return {"data": int(data), "model": int(model)}
