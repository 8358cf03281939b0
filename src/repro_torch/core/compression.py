"""QSGD gradient compression (Alistarh et al., NeurIPS'17) — paper §III-B.4.

For a bucket v of B elements and s quantization levels:
    Q(v_i) = ||v||_2 * sgn(v_i) * xi_i,   xi_i = (l_i + Bern(p_i)) / s
where l_i = floor(s*|v_i|/||v||) and p_i = s*|v_i|/||v|| - l_i. The estimator
is unbiased: E[Q(v)] = v.

Wire format per leaf: int8 signed levels (sign folded into the level) plus
one fp32 norm per bucket -> 8 bits/element + 32/bucket_size overhead versus
32 bits/element uncompressed.

The wire layout is the reference's (``repro/core/compression.py``): each
leaf is taken in the JAX layout (HWIO convolutions, ``(din, dout)`` linear
weights), flattened, zero-padded to whole buckets, and the leaves are
visited in JAX's tree-flatten order. With the same uniforms the payloads
are the reference's byte for byte.

The tensor's device picks the implementation: the CUDA kernels of
``repro_torch.kernels.qsgd`` for a CUDA tensor, their plain PyTorch
versions for a CPU tensor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.convert import jax_order, to_jax_layout, to_torch_layout
from repro_torch.kernels import qsgd as K

Payload = Dict[str, object]


@dataclass(frozen=True)
class QSGDConfig:
    levels: int = 127  # s; must fit in int8 with sign
    bucket: int = 2048  # elements per norm bucket

    @property
    def bits_per_element(self) -> float:
        return 8.0 + 32.0 / self.bucket


def _pad_to_buckets(x: torch.Tensor, bucket: int) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % bucket
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, bucket), pad


def draw_uniforms(shape, generator: torch.Generator) -> torch.Tensor:
    """The rounding uniforms in [0, 1), drawn on the generator's device.

    The one place the codec draws random numbers; parity tests replace it
    to feed the reference's uniforms. The host codec calls it once per leaf
    with ``(nb, bucket)``; the device step's ``qsgd`` combine once per leaf
    with ``(P, nb, bucket)``, leaves in JAX leaf order in both."""
    return torch.rand(shape, generator=generator, device=generator.device)


def quantize(x: torch.Tensor, generator: torch.Generator, cfg: QSGDConfig) -> Payload:
    """One leaf, already in the reference's layout -> ``{"levels": int8
    (nb, bucket), "norms": f32 (nb,)}`` plus shape meta."""
    buckets, pad = _pad_to_buckets(x.to(torch.float32), cfg.bucket)
    u = draw_uniforms(buckets.shape, generator)
    levels, norms = K.qsgd_quantize(buckets.contiguous(), u, cfg.levels)
    return {
        "levels": levels,
        "norms": norms,
        "shape": np.asarray(x.shape, np.int64),
        "pad": np.int64(pad),
    }


def dequantize(payload: Payload, cfg: QSGDConfig) -> torch.Tensor:
    """One payload -> the dense f32 leaf in the reference's layout."""
    flat = K.qsgd_dequantize(payload["levels"], payload["norms"], cfg.levels)
    flat = flat.reshape(-1)
    shape = tuple(int(d) for d in np.asarray(payload["shape"]))
    n = int(np.prod(shape)) if shape else 1
    return flat[:n].reshape(shape)


def dequant_reduce(
    levels: torch.Tensor,  # (P, nb, bucket) int8: the peers' banks
    norms: torch.Tensor,  # (P, nb) f32
    w: torch.Tensor,  # (P,) f32 mixing weights (uniform 1/P on the full graph)
    cfg: QSGDConfig,
) -> torch.Tensor:
    """Fused decode: ``sum_p w[p] * dequantize(levels[p], norms[p])`` ->
    (nb, bucket) f32, in one pass that never builds the P dense banks."""
    return K.qsgd_dequant_reduce(levels, norms, w, cfg.levels)


# ---------------------------------------------------------------------------
# parameter-dict API
# ---------------------------------------------------------------------------


def quantize_tree(
    tree: Mapping[str, torch.Tensor], generator: torch.Generator, cfg: QSGDConfig
) -> Dict[str, Payload]:
    """``{name: tensor}`` in the port's layout -> ``{name: payload}``, leaves
    quantized in JAX leaf order so the uniforms are drawn in that order."""
    return {
        name: quantize(to_jax_layout(tree[name]), generator, cfg)
        for name in jax_order(tree)
    }


def dequantize_tree(payloads: Mapping[str, Payload], cfg: QSGDConfig) -> Dict[str, torch.Tensor]:
    """``{name: payload}`` -> ``{name: dense f32 tensor}`` in the port's layout."""
    return {
        name: to_torch_layout(dequantize(payloads[name], cfg))
        for name in jax_order(payloads)
    }


def payload_bytes(payloads: Mapping[str, Payload]) -> int:
    """Wire size of the compressed gradients."""
    return sum(
        p["levels"].numel() * 1 + p["norms"].numel() * 4 for p in payloads.values()
    )
