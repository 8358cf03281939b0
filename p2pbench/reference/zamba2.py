"""Zamba2 as released (hf ``Zyphra/Zamba2-7B-Instruct``, ``transformers``'
``models/zamba2/modeling_zamba2.py``), cut in depth, in plain PyTorch and
float32. Every layer is a Mamba-2 layer; with e the embeddings and h
starting at e, layer l is

    h + Mamba_l(rmsnorm_l(h))                       (a plain layer)
    h + Mamba_l(rmsnorm_l(h + L_l block_b(h, e)))   (the k-th hybrid layer, b = k mod blocks)

where block_b (``Zamba2AttentionDecoderLayer``, weight-tied across its
applications) is: u = rmsnorm(concat(h, e)) over 2 d; a = W_o attn(rope(W_q
u), rope(W_k u), W_v u), causal multi-head attention at the release's scale
(head_dim / 2)^-1/2 with RoPE over the whole head (``rotate_half``, theta
``rope_theta``); m = rmsnorm(a); the gated MLP of m with the exact GELU,
its gate and up projections plus the application's LoRA B_k A_k m; and L_l
the layer's own (d, d) linear. Mamba_l: ``in_proj`` gives [z, x, B, C,
dt]; a depthwise causal convolution (with bias) and SiLU over [x, B, C];
dt = softplus(dt + dt_bias), A = -exp(A_log); the SSD with head h reading
group h // (H / G) of B and C (``lm.ssd``), plus D x; then y silu(z)
normalised per group of d_inner / G channels (``Zamba2RMSNormGated``) and
``out_proj``. No projection has a bias. Then RMSNorm and the tied head over
the embedding's rows, the logits cut to the vocabulary; the loss is the
mean next-token cross-entropy plus ``1e-4 * mean(lse^2)``.

Departures from ``modeling_zamba2.py``, each noted:
- dt is not clamped: its PyTorch path clamps dt at ``time_step_min``, its
  CUDA path (``time_step_limit`` None) does not; this follows the latter.
- the embedding's rows are padded to a multiple of 256, as the program
  pads them (none at the release's 32,000);
- the loss adds the repository's z-loss, which the release's has not;
- the depth is the configuration's (``num_hidden_layers`` and
  ``hybrid_layer_ids``, cut from the release's 81 and 13);
- float32 throughout, where the release runs in bfloat16.

Each layer runs under ``torch.utils.checkpoint``, and the attention a block
of heads at a time, each block checkpointed too, so that a full-width
backward at 2 x 4,096 tokens holds one layer's activations and one block's
scores at a time.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from p2pbench.reference.lm import Z_LOSS, _rmsnorm, ssd
from p2pbench.reference.precision import operand

HEADS_A_BLOCK = 4  # the attention's heads computed together


def _dims(m: dict) -> dict:
    d = m["d_model"]
    di = m["ssm_expand"] * d
    return dict(d=d, di=di, H=di // m["ssm_headdim"], P=m["ssm_headdim"], N=m["ssm_state"],
                G=m["ssm_ngroups"], K=m["ssm_conv"], f=m["d_ff"], r=m["adapter_rank"],
                heads=m["num_heads"], hd=m["head_dim"], vocab=-(-m["vocab_size"] // 256) * 256)


def param_spec(config: dict) -> List[Tuple[str, tuple, tuple]]:
    """``[(name, shape, init)]``, the program's names; init is ``("normal",
    std)``, ``("const", value)`` or ``("log_linspace", lo, hi)``."""
    m = config["model"]
    if not m["tie_embeddings"]:
        raise ValueError("the Zamba2 reference takes the release's tied head only")
    z = _dims(m)
    d, di, H, N, G, K, f, r = (z[k] for k in ("d", "di", "H", "N", "G", "K", "f", "r"))
    A = z["heads"] * z["hd"]
    lin = lambda name, din, dout: (name, (dout, din), ("normal", 1.0 / math.sqrt(din)))
    ones = lambda name, n: (name, (n,), ("const", 1.0))
    spec = [("embed", (z["vocab"], d), ("normal", 0.02)), ones("final_norm.scale", d)]
    for b in range(m["num_mem_blocks"]):
        p = f"shared_blocks.{b}"
        spec += [ones(f"{p}.ln1.scale", 2 * d), lin(f"{p}.mixer.wq.weight", 2 * d, A),
                 lin(f"{p}.mixer.wk.weight", 2 * d, A), lin(f"{p}.mixer.wv.weight", 2 * d, A),
                 lin(f"{p}.mixer.wo.weight", A, d), ones(f"{p}.ln2.scale", d),
                 lin(f"{p}.ffn.w_gate.weight", d, f), lin(f"{p}.ffn.w_up.weight", d, f),
                 lin(f"{p}.ffn.w_down.weight", f, d)]
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
        if i in m["hybrid_layer_ids"]:
            spec += [lin(f"{p}.adapter_in.weight", d, r), lin(f"{p}.adapter_out.weight", r, 2 * f),
                     lin(f"{p}.linear.weight", d, d)]
    return spec


def _rope(x, positions, theta: float):
    """x (n, S, heads, hd) rotated by position, ``rotate_half`` over the whole head."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(0, 2 * half, 2, dtype=torch.float32, device=x.device)
                          / (2 * half))
    ang = positions.to(torch.float32)[:, None] * inv  # (S, half)
    cos, sin = (torch.cat([t, t], dim=-1)[None, :, None] for t in (ang.cos(), ang.sin()))
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def _heads(q, k, v, scale: float):
    """Causal softmax attention of one block of heads, (n, S, h, hd) each."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bshd->bhqs", q, k) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p, v)


def _block(x, e, p, b: int, layer: int, m, z, qp):
    """Block b of the shared blocks as layer ``layer`` applies it, with that
    layer's LoRA and linear: (n, S, d)."""
    pre, n, S = f"shared_blocks.{b}.", x.shape[0], x.shape[1]
    heads, hd, f = z["heads"], z["hd"], z["f"]
    u = _rmsnorm(torch.cat([x, e], dim=-1), p[pre + "ln1.scale"], m["norm_eps"])
    proj = lambda w: F.linear(qp(u), qp(p[pre + w])).reshape(n, S, heads, hd)
    pos = torch.arange(S, device=x.device)
    q, k = (_rope(proj(w), pos, m["rope_theta"]) for w in ("mixer.wq.weight", "mixer.wk.weight"))
    v = proj("mixer.wv.weight")
    scale = (hd / 2) ** -0.5
    outs = []
    for h0 in range(0, heads, HEADS_A_BLOCK):
        sl = slice(h0, h0 + HEADS_A_BLOCK)
        args = (q[:, :, sl], k[:, :, sl], v[:, :, sl], scale)
        outs.append(checkpoint(_heads, *args, use_reentrant=False) if torch.is_grad_enabled()
                    else _heads(*args))
    a = F.linear(qp(torch.cat(outs, dim=2).reshape(n, S, heads * hd)), qp(p[pre + "mixer.wo.weight"]))
    mm = _rmsnorm(a, p[pre + "ln2.scale"], m["norm_eps"])
    lay = f"layers.{layer}."
    lora = F.linear(qp(F.linear(qp(mm), qp(p[lay + "adapter_in.weight"]))),
                    qp(p[lay + "adapter_out.weight"]))
    gate = F.linear(qp(mm), qp(p[pre + "ffn.w_gate.weight"])) + lora[..., :f]
    up = F.linear(qp(mm), qp(p[pre + "ffn.w_up.weight"])) + lora[..., f:]
    t = F.linear(qp(F.gelu(gate) * up), qp(p[pre + "ffn.w_down.weight"]))
    return F.linear(qp(t), qp(p[lay + "linear.weight"]))


def _mamba(x, into, p, i: int, m, z, qp):
    """x + Mamba_i(rmsnorm_i(into)): the layer's Mamba-2 mixer on ``into``
    (x, or x plus a hybrid layer's block output), added to x."""
    pre = f"layers.{i}.mixer."
    di, H, Pd, N, G, K = z["di"], z["H"], z["P"], z["N"], z["G"], z["K"]
    n, S = x.shape[:2]
    h = _rmsnorm(into, p[f"layers.{i}.ln1.scale"], m["norm_eps"])
    proj = F.linear(qp(h), qp(p[pre + "in_proj.weight"]))
    zg, xbc, dt = torch.split(proj, [di, di + 2 * G * N, H], dim=-1)
    xbc = F.conv1d(xbc.transpose(1, 2), p[pre + "conv_w"], p[pre + "conv_b"], padding=K - 1,
                   groups=xbc.shape[-1])[..., :S].transpose(1, 2)
    xs, Bm, Cm = torch.split(F.silu(xbc), [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt + p[pre + "dt_bias"])
    A = -torch.exp(p[pre + "A_log"])
    xs = xs.reshape(n, S, H, Pd)
    y = ssd(xs, dt, A, Bm.reshape(n, S, G, N), Cm.reshape(n, S, G, N), m["ssm_chunk"])
    y = (y + xs * p[pre + "D"][:, None]).reshape(n, S, di)
    gated = (y * F.silu(zg)).reshape(n, S, G, di // G)
    y = _rmsnorm(gated, p[pre + "norm.scale"].reshape(G, di // G), m["norm_eps"]).reshape(n, S, di)
    return x + F.linear(qp(y), qp(p[pre + "out_proj.weight"]))


def hidden(params: Dict[str, torch.Tensor], tokens: torch.Tensor, config: dict,
           precision: str = "f32") -> torch.Tensor:
    """The hidden state after the final norm, (n, S, d)."""
    m = config["model"]
    z = _dims(m)
    qp = lambda t: operand(t, precision)
    e = params["embed"][tokens]
    x, k_app = e, 0
    for i in range(m["num_layers"]):
        if i in m["hybrid_layer_ids"]:
            b = k_app % m["num_mem_blocks"]
            fn = lambda x, e, i=i, b=b: _mamba(x, x + _block(x, e, params, b, i, m, z, qp), params,
                                               i, m, z, qp)
            args = (x, e)
            k_app += 1
        else:
            fn = lambda x, i=i: _mamba(x, x, params, i, m, z, qp)
            args = (x,)
        x = checkpoint(fn, *args, use_reentrant=False) if torch.is_grad_enabled() else fn(*args)
    return _rmsnorm(x, params["final_norm.scale"], m["norm_eps"])


def logits(params, tokens, config: dict, precision: str = "f32") -> torch.Tensor:
    """(n, S, vocab) f32 logits of the tied head."""
    x = hidden(params, tokens, config, precision)
    w = params["embed"]
    return F.linear(operand(x, precision), operand(w, precision))[..., : config["model"]["vocab_size"]]


def loss(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], config: dict,
         precision: str = "f32") -> torch.Tensor:
    """Mean loss of ``batch["tokens"]`` and ``batch["labels"]`` (n, S) int64
    over all tokens, with the z-loss."""
    z = logits(params, batch["tokens"], config, precision)
    lse = torch.logsumexp(z, dim=-1)
    gold = z.gather(-1, batch["labels"][..., None])[..., 0]
    return (lse - gold).mean() + Z_LOSS * torch.square(lse).mean()
