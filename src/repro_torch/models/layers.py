"""Model primitives of the port: the parts of the reference's
``repro/models/layers.py`` that its LMs and encoder-decoder use.

Parameters are stored in ``param_dtype`` (float32) and cast to the
config's working dtype (bfloat16) at each use, as in the reference.
Linear weights are ``nn.Linear`` weights, (out, in); ``convert.py``
transposes them from the reference's (in, out). Attention keeps the
reference's layouts at its functions: q (B, S, H, D), k and v
(B, S, K, D), a KV cache {"k", "v"} of (B, S_cache, K, D). The one plain
attention, ``attend``, lives beside the flash kernel in
``kernels/flash_attention.py``. The MoE layer's expert banks keep the
reference's layout, ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d);
its router and its shared expert are ``nn.Linear`` weights. The
reference's ``shard`` hints have no counterpart on one card.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import attend, flash_attention, softcap

Cache = Dict[str, torch.Tensor]


def dense_init(in_dim: int, out_dim: int, *, generator: torch.Generator, device, dtype) -> torch.Tensor:
    """A linear weight in the port's layout (out_dim, in_dim), normal with
    std 1/sqrt(in_dim) as the reference's ``_dense_init``."""
    w = torch.randn((out_dim, in_dim), generator=generator, device=device)
    return (w / math.sqrt(in_dim)).to(dtype)


def dense_linear(in_dim: int, out_dim: int, *, generator: torch.Generator, device, dtype) -> nn.Linear:
    """A bias-free ``nn.Linear`` whose weight is ``dense_init``'s."""
    lin = skip_init(nn.Linear, in_dim, out_dim, bias=False, device=device, dtype=dtype)
    lin.weight.data = dense_init(in_dim, out_dim, generator=generator, device=device, dtype=dtype)
    return lin


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if kind == "gelu_erf":
        return F.gelu(x)  # the exact GELU (the Zamba2 release's ``hidden_act``)
    if kind == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {kind}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in float32 and cast back to ``x``'s dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def rmsnorm_grouped(x: torch.Tensor, scale: torch.Tensor, eps: float, groups: int) -> torch.Tensor:
    """``rmsnorm`` with each of ``groups`` equal slices of the last dimension
    normalised on its own (Mamba-2's gated norm at ``ssm_ngroups`` > 1); one
    group is ``rmsnorm`` itself."""
    if groups == 1:
        return rmsnorm(x, scale, eps)
    x32 = x.to(torch.float32).unflatten(-1, (groups, x.shape[-1] // groups))
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)).flatten(-2) * scale.to(torch.float32)).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, device, dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((dim,), device=device, dtype=dtype))

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return rmsnorm(x, self.scale, eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings (GPT-NeoX half rotation)
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) int -> (sin, cos) of shape (..., S, head_dim // 2), f32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=positions.device) / half))
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); sin/cos (B, S, D/2) or (S, D/2), cast to x's dtype
    before the multiply, as in the reference."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.dim() == 2:
        sin, cos = sin[None], cos[None]
    sin, cos = sin[:, :, None, :].to(x.dtype), cos[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA, sliding window, softcap, KV cache)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """The parameters of the reference's ``init_attention``: ``wq``, ``wk``,
    ``wv``, ``wo`` and, with ``qkv_bias``, ``bq``, ``bk``, ``bv``. ``in_dim``
    (default ``d_model``) is the width q, k and v are projected from: the
    Zamba2 release's shared block attends over concat(hidden, embeddings),
    2 d_model wide; ``wo`` returns d_model."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator, device, in_dim: int = 0):
        super().__init__()
        d, hd, H, K = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
        din = in_dim or d
        pdt = getattr(torch, cfg.param_dtype)
        lin = functools.partial(dense_linear, generator=generator, device=device, dtype=pdt)
        self.wq, self.wk, self.wv, self.wo = (lin(din, H * hd), lin(din, K * hd), lin(din, K * hd),
                                              lin(H * hd, d))
        if cfg.qkv_bias:
            zeros = lambda n: nn.Parameter(torch.zeros((n,), device=device, dtype=pdt))
            self.bq, self.bk, self.bv = zeros(H * hd), zeros(K * hd), zeros(K * hd)


def attention_apply(
    attn: Attention,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # (S,) absolute positions of x
    causal: bool = True,
    window: int = 0,
    cache: Optional[Cache] = None,  # prefill / decode: {"k", "v"} buffers
    cache_pos: Optional[int] = None,  # decode: the current position
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    scale: Optional[float] = None,  # the scores' scale; None: 1 / sqrt(head_dim)
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """The reference's ``attention_apply``, self-attention on three routes:
    the full sequence (no cache), prefill (a cache and S > 1) and decode (a
    cache and S = 1). Prefill and decode write the cache buffers in place,
    where the reference returns new ones (a decode step would otherwise copy
    every layer's whole cache), and return the same buffers.

    The full-sequence and prefill routes go through the flash kernel,
    causal or not (``causal=False`` is whisper's encoder, at window 0):
    their positions are ``arange(S)``, where it computes ``attend``'s
    function (on the CPU the wrapper takes its plain version). Decode
    attends over the rolling cache by position, through ``attend``.

    With ``cross_kv``, the encoder's precomputed K/V (B, Senc, K, hd), it is
    whisper's cross attention: q from ``wq`` (and ``bq``), no RoPE, every
    query over every encoder position (``causal=False``), then ``wo``; the
    cache is returned as given. A decoding step (``cache_pos`` given and S =
    1) attends through ``attend``, any other call through the flash kernel.

    ``scale`` replaces the scores' 1 / sqrt(head_dim) on the full-sequence
    route (the Zamba2 release's (head_dim / 2)^-1/2); the cache routes take
    only the default."""
    B, S, _ = x.shape
    if scale is not None and (cache is not None or cross_kv is not None):
        raise ValueError("a non-default attention scale is taken on the full-sequence route only")
    hd, H, K = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype
    q = F.linear(x, attn.wq.weight.to(dt)).reshape(B, S, H, hd)
    if cfg.qkv_bias:
        q = q + attn.bq.to(dt).reshape(H, hd)
    cap = cfg.attn_logit_softcap

    if cross_kv is not None:
        kx, vx = cross_kv
        if cache_pos is not None and S == 1:
            o = attend(q, kx, vx, causal=False, q_positions=positions,
                       kv_positions=torch.arange(kx.shape[1], device=x.device), softcap_val=cap)
        else:
            o = flash_attention(q, kx, vx, causal=False, softcap=cap)
        return F.linear(o.reshape(B, S, H * hd), attn.wo.weight.to(dt)), cache

    k = F.linear(x, attn.wk.weight.to(dt)).reshape(B, S, K, hd)
    v = F.linear(x, attn.wv.weight.to(dt)).reshape(B, S, K, hd)
    if cfg.qkv_bias:
        k = k + attn.bk.to(dt).reshape(K, hd)
        v = v + attn.bv.to(dt).reshape(K, hd)
    if cfg.rope_theta:
        sin, cos = rope_tables(positions, hd, cfg.rope_theta)
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)

    if cache is not None and S == 1:
        # decode: write this step's K/V into the cache, attend over the cache
        Sc = cache["k"].shape[1]
        j = torch.arange(Sc, device=x.device)
        if window and Sc == window:
            slot = cache_pos % window
            kv_pos = cache_pos - torch.remainder(cache_pos - j, window)  # slot j's position
        else:
            slot = cache_pos
            kv_pos = torch.where(j <= cache_pos, j, -1)
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        kv_pos = torch.where(kv_pos >= 0, kv_pos, -1)
        o = attend(q, cache["k"], cache["v"], causal=True, q_positions=positions,
                   kv_positions=kv_pos, window=window, softcap_val=cap)
        return F.linear(o.reshape(B, S, H * hd), attn.wo.weight.to(dt)), cache

    if cache is not None:
        # prefill: the whole prompt's K/V into the cache; a rolling cache
        # keeps the last Sc tokens, token t at slot t % Sc
        Sc = cache["k"].shape[1]
        if Sc < S:
            perm = torch.remainder(torch.arange(Sc, device=x.device) - S, Sc) + (S - Sc)
            cache["k"].copy_(k[:, perm])
            cache["v"].copy_(v[:, perm])
        else:
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
    o = flash_attention(q, k, v, causal=causal, softcap=cap, window=window, scale=scale)
    return F.linear(o.reshape(B, S, H * hd), attn.wo.weight.to(dt)), cache


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int, layer_window: int, dtype, *,
                      device) -> Cache:
    """Cache buffers of one attention layer (rolling if windowed)."""
    size = min(seq_len, layer_window) if layer_window else seq_len
    shape = (batch, size, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """The parameters of the reference's ``init_mlp``."""

    def __init__(self, d: int, f: int, *, generator: torch.Generator, device, dtype):
        super().__init__()
        self.w_gate = dense_linear(d, f, generator=generator, device=device, dtype=dtype)
        self.w_up = dense_linear(d, f, generator=generator, device=device, dtype=dtype)
        self.w_down = dense_linear(f, d, generator=generator, device=device, dtype=dtype)


def mlp_apply(mlp: MLP, x: torch.Tensor, act: str, lora=None) -> torch.Tensor:
    """The gated MLP. ``lora``, (A (rank, d), B (2 f, rank)), adds B A x to
    the gate and up projections, [gate | up] along B's rows, before the
    activation: the Zamba2 release's per-application adapter on its
    ``gate_up_proj``."""
    dt = x.dtype
    gate = F.linear(x, mlp.w_gate.weight.to(dt))
    u = F.linear(x, mlp.w_up.weight.to(dt))
    if lora is not None:
        a, b = lora
        gu = F.linear(F.linear(x, a.to(dt)), b.to(dt))
        gate, u = gate + gu[..., :gate.shape[-1]], u + gu[..., gate.shape[-1]:]
    return F.linear(activation(gate, act) * u, mlp.w_down.weight.to(dt))


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k)
#
# The reference's einsums and gathers, outside any Pallas kernel there, so
# plain PyTorch here. The dense dispatch runs every expert on every token
# of a chunk (the gates zero the unrouted pairs); the capacity dispatch
# gathers each expert's routed tokens into C slots and drops the overflow.
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """The parameters of the reference's ``init_moe``: ``router`` (d -> E),
    the expert banks ``w_gate``, ``w_up`` (E, d, f) and ``w_down`` (E, f, d),
    and with ``cfg.moe_shared_ff`` the always-on ``shared`` MLP."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator, device):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        pdt = getattr(torch, cfg.param_dtype)
        self.router = dense_linear(d, E, generator=generator, device=device, dtype=pdt)

        def bank(shape, fan_in):
            w = torch.randn(shape, generator=generator, device=device) / math.sqrt(fan_in)
            return nn.Parameter(w.to(pdt))

        self.w_gate = bank((E, d, f), d)
        self.w_up = bank((E, d, f), d)
        self.w_down = bank((E, f, d), f)
        if cfg.moe_shared_ff:
            self.shared = MLP(d, cfg.moe_shared_ff, generator=generator, device=device, dtype=pdt)


def router_topk(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, E) router logits -> (dense gates (T, E), the Switch load-balance
    aux loss, the probabilities), as the reference's ``router_topk``: the k
    largest probabilities renormalised to sum 1. The one-hot is a
    comparison with ``arange(E)`` (``F.one_hot`` has no vmap rule)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    vals, idx = torch.topk(probs, k)
    vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    E = probs.shape[-1]
    onehot = (idx[..., None] == torch.arange(E, device=idx.device)).to(torch.float32)  # (T, k, E)
    dense_gates = (onehot * vals[..., None]).sum(dim=-2)
    frac_tokens = (onehot.sum(-2) > 0).to(torch.float32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return dense_gates, aux, probs


def _experts_dense(xi, gi, wg, wu, wd, act: str) -> torch.Tensor:
    """One chunk of the dense dispatch: every expert on every token (E, Tc,
    f), gated, then one product over (expert, f), in the reference's order
    (XLA computes its ``etf,efd,te->td`` as the gated h, then that product)."""
    h = activation(torch.matmul(xi, wg), act) * torch.matmul(xi, wu)  # (E, Tc, f)
    h = h * gi.t()[:, :, None]
    E, Tc, f = h.shape
    return h.transpose(0, 1).reshape(Tc, E * f) @ wd.reshape(E * f, -1)


def moe_apply(
    moe: MoE,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    *,
    dispatch: str = "dense",
    token_chunk: int = 4096,
    capacity_factor: float = 1.25,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``moe_apply``: returns (y (B, S, d), the aux loss in
    f32). ``dispatch="dense"`` runs the tokens in chunks of about
    ``token_chunk`` (the reference's chunk rule; a loop where it scans);
    ``"capacity"`` computes only the routed tokens, ``capacity_factor``
    sizing each expert's slots. Another dispatch raises ``ValueError``."""
    B, S, d = x.shape
    dt = x.dtype
    T = B * S
    xt = x.reshape(T, d)
    logits = F.linear(xt, moe.router.weight.to(dt))  # (T, E)
    gates, aux, _ = router_topk(logits, cfg.experts_per_token)
    gates = gates.to(dt)
    wg, wu, wd = moe.w_gate.to(dt), moe.w_up.to(dt), moe.w_down.to(dt)

    if dispatch == "dense":
        nchunks = max(1, T // max(token_chunk, 1)) if T > token_chunk else 1
        while T % nchunks:
            nchunks -= 1
        Tc = T // nchunks
        y = torch.cat([_experts_dense(xt[c * Tc:(c + 1) * Tc], gates[c * Tc:(c + 1) * Tc],
                                      wg, wu, wd, cfg.act) for c in range(nchunks)])
    elif dispatch == "capacity":
        y = _moe_capacity(xt, gates, wg, wu, wd, cfg, capacity_factor)
    else:
        raise ValueError(f"unknown moe dispatch {dispatch!r}")

    if cfg.moe_shared_ff:
        y = y + mlp_apply(moe.shared, xt, cfg.act)
    return y.reshape(B, S, d), aux.to(torch.float32)


def _moe_capacity(xt, gates, wg, wu, wd, cfg: ModelConfig, capacity_factor: float) -> torch.Tensor:
    """The reference's ``_moe_capacity``: each routed (token, expert) pair
    takes the next of the expert's C = ceil(k T / E x capacity_factor) slots
    in token order (a cumulative count down the tokens); pairs past C are
    dropped. The (E, C) slot table is a max-scatter of token indices, an
    empty slot holding token 0 and a zero gate."""
    T, E = gates.shape
    C = max(int(math.ceil(cfg.experts_per_token * T / E * capacity_factor)), 1)
    dev = gates.device
    routed = gates > 0
    pos = torch.cumsum(routed.to(torch.int64), dim=0) - 1  # (T, E): slot within the expert
    keep = routed & (pos < C)
    dest = torch.where(keep, torch.arange(E, device=dev)[None, :] * C + pos, E * C).reshape(-1)
    table = lambda src: torch.zeros(E * C + 1, dtype=torch.int64, device=dev).scatter_reduce(
        0, dest, src.reshape(-1), reduce="amax")[: E * C].reshape(E, C)
    slot_token = table(torch.arange(T, device=dev)[:, None].expand(T, E))
    occupied = table(keep.to(torch.int64)) > 0
    xe = torch.where(occupied[..., None], xt[slot_token], 0)  # (E, C, d)
    h = activation(torch.bmm(xe, wg), cfg.act) * torch.bmm(xe, wu)
    ye = torch.bmm(h, wd)  # (E, C, d)
    g = gates[slot_token, torch.arange(E, device=dev)[:, None]]  # (E, C)
    ye = ye * (g * occupied)[..., None]
    return torch.zeros_like(xt).index_add(0, slot_token.reshape(-1), ye.reshape(E * C, -1))
