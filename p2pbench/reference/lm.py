"""A decoder-only LM of Mamba-2 layers (arXiv:2405.21060), as the
state-spaces release builds it, in plain PyTorch and float32. Per layer:
``x + out_proj(gated_rmsnorm(ssd(conv(in_proj(rmsnorm(x))))))``:
``in_proj`` gives [z, x, B, C, dt]; a depthwise causal convolution of
width ``ssm_conv`` (with bias) and SiLU over [x, B, C]; dt = softplus(dt +
dt_bias), A = -exp(A_log); the SSD scan in chunks with the segment sums
taken stably (the paper's Listing 1), plus D x; then RMSNorm of y *
silu(z). Then RMSNorm and the tied (or untied) head over the embedding's
rows, the logits cut to the vocabulary; the loss is the mean next-token
cross-entropy plus ``1e-4 * mean(lse^2)``, the z-loss of the repository's
LM training.

Each layer runs under ``torch.utils.checkpoint``, so that a full-width
backward holds one layer's activations at a time.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from p2pbench.reference.precision import operand

Z_LOSS = 1e-4


def _dims(m: dict) -> dict:
    d = m["d_model"]
    di = m["ssm_expand"] * d
    return dict(d=d, di=di, H=di // m["ssm_headdim"], P=m["ssm_headdim"], N=m["ssm_state"],
                G=m["ssm_ngroups"], K=m["ssm_conv"], vocab=-(-m["vocab_size"] // 256) * 256)


def param_spec(config: dict) -> List[Tuple[str, tuple, tuple]]:
    """``[(name, shape, init)]``; init is ``("normal", std)``, ``("const",
    value)`` or ``("log_linspace", lo, hi)``."""
    m = config["model"]
    z = _dims(m)
    d, di, H, N, G, K = z["d"], z["di"], z["H"], z["N"], z["G"], z["K"]
    lin = lambda name, din, dout: (name, (dout, din), ("normal", 1.0 / math.sqrt(din)))
    ones = lambda name, n: (name, (n,), ("const", 1.0))
    spec = [("embed", (z["vocab"], d), ("normal", 0.02)), ones("final_norm.scale", d)]
    if not m["tie_embeddings"]:
        spec.append(lin("unembed.weight", d, z["vocab"]))
    conv_ch = di + 2 * G * N
    for i in range(m["num_layers"]):
        p = f"layers.{i}"
        spec += [ones(f"{p}.ln1.scale", d),
                 lin(f"{p}.mixer.in_proj.weight", d, 2 * di + 2 * G * N + H),
                 (f"{p}.mixer.conv_w", (conv_ch, 1, K), ("normal", 0.1)),
                 (f"{p}.mixer.conv_b", (conv_ch,), ("const", 0.0)),
                 (f"{p}.mixer.A_log", (H,), ("log_linspace", 1.0, 16.0)),
                 (f"{p}.mixer.D", (H,), ("const", 1.0)),
                 (f"{p}.mixer.dt_bias", (H,), ("const", 0.0)),
                 ones(f"{p}.mixer.norm.scale", di),
                 lin(f"{p}.mixer.out_proj.weight", di, d)]
    return spec


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., T) -> (..., T, T): out[i, j] = a[j+1] + ... + a[i] for i >= j,
    -inf above the diagonal; each segment summed on its own."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)
    below = torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1)
    x = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    return x.masked_fill(~torch.ones_like(below).tril(0), float("-inf"))


def ssd(x, dt, A, B, C, chunk: int):
    """The selective state-space scan y_t = C_t h_t, h_t = exp(dt_t A) h_{t-1}
    + dt_t B_t x_t^T, for a batch of sequences: x (n, S, H, P), dt (n, S, H),
    A (H,), B and C (n, S, G, N) -> y (n, S, H, P); chunked as the paper's
    Listing 1."""
    n, S, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    pad = (-S) % chunk
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, 0, 0, pad)), F.pad(C, (0, 0, 0, 0, 0, pad))
    c = (S + pad) // chunk
    Bh = B.repeat_interleave(H // G, dim=2).reshape(n, c, chunk, H, N)
    Ch = C.repeat_interleave(H // G, dim=2).reshape(n, c, chunk, H, N)
    X = (x * dt[..., None]).reshape(n, c, chunk, H, Pd)
    a = (dt * A).reshape(n, c, chunk, H).permute(0, 3, 1, 2)  # (n, H, c, l)
    cum = torch.cumsum(a, dim=-1)
    L = torch.exp(_segsum(a))  # (n, H, c, l, s)
    scores = torch.einsum("bclhn,bcshn->bhcls", Ch, Bh) * L
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, X)
    decay_states = torch.exp(cum[..., -1:] - cum)  # (n, H, c, l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay_states, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)  # (n, c + 1, H, P, N)
    decay_chunk = torch.exp(_segsum(F.pad(cum[..., -1], (1, 0))))  # (n, H, c + 1, c + 1)
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, states, torch.exp(cum))
    return (y_diag + y_off).reshape(n, c * chunk, H, Pd)[:, :S]


def _mamba(x, p, i, m, z, q):
    pre = f"layers.{i}.mixer."
    d, di, H, Pd, N, G, K = z["d"], z["di"], z["H"], z["P"], z["N"], z["G"], z["K"]
    n, S = x.shape[:2]
    h = _rmsnorm(x, p[f"layers.{i}.ln1.scale"], m["norm_eps"])
    proj = F.linear(q(h), q(p[pre + "in_proj.weight"]))
    zg, xbc, dt = torch.split(proj, [di, di + 2 * G * N, H], dim=-1)
    xbc = F.conv1d(xbc.transpose(1, 2), p[pre + "conv_w"], p[pre + "conv_b"], padding=K - 1,
                   groups=xbc.shape[-1])[..., :S].transpose(1, 2)
    xs, Bm, Cm = torch.split(F.silu(xbc), [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt + p[pre + "dt_bias"])
    A = -torch.exp(p[pre + "A_log"])
    xs = xs.reshape(n, S, H, Pd)
    y = ssd(xs, dt, A, Bm.reshape(n, S, G, N), Cm.reshape(n, S, G, N), m["ssm_chunk"])
    y = (y + xs * p[pre + "D"][:, None]).reshape(n, S, di)
    y = _rmsnorm(y * F.silu(zg), p[pre + "norm.scale"], m["norm_eps"])
    return x + F.linear(q(y), q(p[pre + "out_proj.weight"]))


def loss(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], config: dict,
         precision: str = "f32") -> torch.Tensor:
    """Mean loss of ``batch["tokens"]`` and ``batch["labels"]`` (n, S) int64:
    each row's tokens' mean, averaged over the rows (rows of one length, so
    the mean over all tokens)."""
    m = config["model"]
    z = _dims(m)
    q = lambda t: operand(t, precision)
    x = params["embed"][batch["tokens"]]
    for i in range(m["num_layers"]):
        fn = lambda x, i=i: _mamba(x, params, i, m, z, q)
        x = checkpoint(fn, x, use_reentrant=False) if torch.is_grad_enabled() else fn(x)
    x = _rmsnorm(x, params["final_norm.scale"], m["norm_eps"])
    w = params["embed"] if m["tie_embeddings"] else params["unembed.weight"]
    logits = F.linear(q(x), q(w))[..., : m["vocab_size"]]
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"][..., None])[..., 0]
    return (lse - gold).mean() + Z_LOSS * torch.square(lse).mean()
