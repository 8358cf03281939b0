"""Model primitives of the port that the Mamba-2 LM uses: the subset of the
reference's ``repro/models/layers.py`` on the SSM path.

Parameters are stored in ``param_dtype`` (float32) and cast to the
config's working dtype (bfloat16) at each use, as in the reference.
Attention, the MLP, MoE and the RoPE helpers come with the attention
families (ROADMAP.md, Queue 1, item 11). The reference's ``shard`` hints
have no counterpart on one card.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def dense_init(in_dim: int, out_dim: int, *, generator: torch.Generator, device, dtype) -> torch.Tensor:
    """A linear weight in the port's layout (out_dim, in_dim), normal with
    std 1/sqrt(in_dim) as the reference's ``_dense_init``."""
    w = torch.randn((out_dim, in_dim), generator=generator, device=device)
    return (w / math.sqrt(in_dim)).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap else x


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in float32 and cast back to ``x``'s dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, device, dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((dim,), device=device, dtype=dtype))

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return rmsnorm(x, self.scale, eps)
