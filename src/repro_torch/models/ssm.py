"""Mamba-2 (SSD, state-space duality) blocks of the port.

A copy of the reference's ``repro/models/ssm.py`` in PyTorch. A full
sequence runs the chunked SSD algorithm (arXiv:2405.21060 §6): the
intra-chunk dual form plus the inter-chunk state recurrence. Scoring may
take the hand-written forward kernel (``kernels/ssd_scan.py``, no
gradient); otherwise a full sequence in bf16 on the card, training
included, takes ``ssd_chunked_grad`` (the forward kernel and its backward
kernel) where its widths and chunk allow, and the plain ``ssd_chunked``
elsewhere (the CPU, f32, other shapes); prefill takes ``ssd_chunked``, which
also returns the final state; decode takes the O(1) recurrent step. Before
the scan, a full sequence in bf16 on the card takes the causal conv, its
bias and SiLU as one kernel and its gradient as another
(``kernels/causal_conv.py``), reading x, B and C in place from the input
projection; elsewhere (the CPU, f32, prefill, decode) the plain
``causal_conv`` and ``F.silu``.

The gated RMSNorm normalises the whole width, as the reference does at any
``ssm_ngroups``; in the Zamba2 release's layout (the port's own) it
normalises each of the ``ssm_ngroups`` groups of channels apart, as that
release does (``ModelConfig.ssm_norm_groups``).

Public functions keep the reference's layouts: x (B, S, H, P), B/C
(B, S, G, N), a convolution weight (K, C). The module stores its
depthwise convolution weight as PyTorch's ``Conv1d`` does, (C, 1, K), and
its projections as ``nn.Linear`` (out, in).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.causal_conv import causal_conv, causal_conv_silu, conv_takes
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_chunked_grad, ssd_grad_takes, ssd_scan
from repro_torch.models.layers import RMSNorm, dense_linear, rmsnorm_grouped

State = Dict[str, torch.Tensor]


class Mamba2(nn.Module):
    """The parameters of the reference's ``init_mamba2``. ``in_proj``'s
    output is ordered [z (di), x (di), B (G*N), C (G*N), dt (H)]."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator, device):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_ngroups
        conv_ch = di + 2 * G * N
        pdt = getattr(torch, cfg.param_dtype)
        self.in_proj = dense_linear(d, 2 * di + 2 * G * N + H, generator=generator, device=device,
                                    dtype=pdt)
        conv = torch.randn((cfg.ssm_conv, conv_ch), generator=generator, device=device) * 0.1
        self.conv_w = nn.Parameter(conv.t().reshape(conv_ch, 1, cfg.ssm_conv).to(pdt))
        self.conv_b = nn.Parameter(torch.zeros((conv_ch,), device=device, dtype=pdt))
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, H, device=device)).to(pdt))
        self.D = nn.Parameter(torch.ones((H,), device=device, dtype=pdt))
        self.dt_bias = nn.Parameter(torch.zeros((H,), device=device, dtype=pdt))
        self.norm = RMSNorm(di, device=device, dtype=pdt)
        self.out_proj = dense_linear(di, d, generator=generator, device=device, dtype=pdt)

    def conv_kc(self) -> torch.Tensor:
        """The convolution weight in the reference's (K, C) layout (a view)."""
        return self.conv_w[:, 0, :].t()


def ssd_decode_step(
    x: torch.Tensor,  # (B, H, P)
    dt: torch.Tensor,  # (B, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, G, N)
    Cm: torch.Tensor,  # (B, G, N)
    state: torch.Tensor,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step -> (y (B, H, P) f32, new state (B, H, P, N))."""
    f32 = torch.float32
    rep = x.shape[1] // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1).to(f32)  # (B, H, N)
    Ch = Cm.repeat_interleave(rep, dim=1).to(f32)
    decay = torch.exp(dt.to(f32) * A.to(f32))  # (B, H)
    upd = torch.einsum("bhp,bhk->bhpk", x.to(f32) * dt.to(f32)[..., None], Bh)
    new_state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpk,bhk->bhp", new_state, Ch)
    return y, new_state


def mamba2_apply(
    mod: Mamba2,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    *,
    state: Optional[State] = None,  # decode: {"ssm": (B, H, P, N), "conv": (B, K-1, C)}
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, Optional[State]]:
    """The reference's ``mamba2_apply``, three routes: a full sequence
    (``state`` None) through the SSD kernel when ``use_kernel`` (no
    gradient), else through ``ssd_chunked_grad`` (the forward and backward
    kernels) where ``ssd_grad_takes`` the inputs (CUDA or meta, bf16, the
    kernels' widths and chunk), else the plain ``ssd_chunked``; a prefill
    (``state`` given, S > 1) through ``ssd_chunked``, filling the decode
    state; and one decode step. A full sequence applies the conv, its bias
    and SiLU through ``causal_conv_silu`` (the kernels) where
    ``conv_takes`` the inputs (CUDA or meta, bf16, C a multiple of 4, K <=
    4, 8-byte strides), else through the plain ``causal_conv``."""
    B, S, _ = x.shape
    di, H, N, G = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_ngroups
    Pd = cfg.ssm_headdim
    dt_ = x.dtype
    f32 = torch.float32

    proj = F.linear(x, mod.in_proj.weight.to(dt_))
    # x, B and C are adjacent columns of the projection: one (B, S, conv_ch) view
    z, conv_in, dt_raw = torch.split(proj, [di, di + 2 * G * N, H], dim=-1)
    A = -torch.exp(mod.A_log.to(f32))

    if state is None or S > 1:
        w, b = mod.conv_kc().to(dt_), mod.conv_b.to(dt_)
        if state is None and conv_takes(conv_in, w, b):
            conv_out = causal_conv_silu(conv_in, w, b)
        else:
            conv_out = F.silu(causal_conv(conv_in, w, b))
        xs, Bm, Cm = torch.split(conv_out, [di, G * N, G * N], dim=-1)
        xs = xs.reshape(B, S, H, Pd)
        Bm = Bm.reshape(B, S, G, N)
        Cm = Cm.reshape(B, S, G, N)
        dtv = F.softplus(dt_raw.to(f32) + mod.dt_bias.to(f32))
        if use_kernel and state is None:
            y, final = ssd_scan(xs, dtv, A, Bm, Cm, chunk=cfg.ssm_chunk), None
        elif state is None and ssd_grad_takes(xs, Bm, Cm, cfg.ssm_chunk):
            y, final = ssd_chunked_grad(xs, dtv, A, Bm, Cm, cfg.ssm_chunk), None
        else:
            y, final = ssd_chunked(xs, dtv, A, Bm, Cm, cfg.ssm_chunk)
        y = y + xs.to(f32) * mod.D.to(f32)[:, None]
        y = y.reshape(B, S, di).to(dt_)
        new_state = None
        if state is not None:
            K = cfg.ssm_conv
            # a copy: a view of conv_in would keep the whole projection alive
            tail = conv_in[:, -(K - 1):].contiguous() if S >= K - 1 else torch.cat(
                [state["conv"][:, S:], conv_in], dim=1)
            new_state = {"ssm": final.to(state["ssm"].dtype), "conv": tail.to(state["conv"].dtype)}
    else:
        # single-token decode
        conv_buf = torch.cat([state["conv"], conv_in.to(state["conv"].dtype)], dim=1)  # (B, K, C)
        w = mod.conv_kc().to(dt_)
        conv_out = F.silu((conv_buf.to(dt_) * w[None]).sum(dim=1) + mod.conv_b.to(dt_))  # (B, C)
        xs1, Bm1, Cm1 = torch.split(conv_out, [di, G * N, G * N], dim=-1)
        xs1 = xs1.reshape(B, H, Pd)
        dtv = F.softplus(dt_raw[:, 0].to(f32) + mod.dt_bias.to(f32))  # (B, H)
        y1, ssm_new = ssd_decode_step(xs1, dtv, A, Bm1.reshape(B, G, N), Cm1.reshape(B, G, N),
                                      state["ssm"].to(f32))
        y1 = y1 + xs1.to(f32) * mod.D.to(f32)[:, None]
        y = y1.reshape(B, 1, di).to(dt_)
        new_state = {"ssm": ssm_new.to(state["ssm"].dtype), "conv": conv_buf[:, 1:]}

    # gated RMSNorm (in the release layout each B/C group of channels on its
    # own, ``cfg.ssm_norm_groups``), then the output projection
    y = rmsnorm_grouped(y * F.silu(z), mod.norm.scale, cfg.norm_eps, cfg.ssm_norm_groups)
    return F.linear(y, mod.out_proj.weight.to(dt_)), new_state


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype: torch.dtype, *, device) -> State:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype, device=device),
    }
