"""Flash attention: CUDA kernels for Hopper (forward and backward) beside
their plain PyTorch versions, and the port's one plain attention, ``attend``.

The forward replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py:flash_attention`` (``_flash_kernel``).
Its CUDA source is ``csrc/flash_attention.cu``; its header says what bounds
the kernel on the card and how it tiles. It has one body for each input
type: f32 runs on the CUDA cores, bf16 on the tensor cores (``wgmma`` on
tiles that the Tensor Memory Accelerator loads). The backward,
``csrc/flash_attention_bwd.cu``, stands for the reference's ``jax.grad``
of the same function (its models differentiate ``attend``; the Pallas
kernel has no backward). It has one body for each input type too: bf16
runs two launches on the tensor cores (delta = sum_j p dP / sum_j p, then
dq, in one; dk and dv in the other), from the forward's saved log-sum-exp;
f32 runs three launches on the CUDA cores that recompute it. The forward
still saves o in f32 beside lse, which the bf16 backward no longer reads.

The kernels' function, for query i and key j with positions counted from
0 on both sides (also when Sq != Skv), query head h reading KV head
h // (H / K):

    s_ij  = (q_i * scale) . k_j                   in f32, scale 1 / sqrt(D) by default
    s_ij  = tanh(s_ij / softcap) * softcap        when softcap > 0
    valid = j < Skv and, only when causal, 0 <= i - j < window  (window 0: none)
    o_i   = softmax over the valid j of s_ij, times v, cast to q's dtype

Every function here takes ``scale`` (None: 1 / sqrt(D)); the Zamba2
release's shared attention scores at (D / 2)^-1/2.
Without ``causal`` the window is ignored, as the Pallas kernel ignores it
(``attend`` bounds |i - j| there; ``flash_attention_plain`` therefore
passes it no window).

``flash_attention`` is a ``torch.autograd.Function`` (:class:`FlashAttentionFn`)
that works under ``torch.func`` transforms: its ``vmap`` rule folds a
vmapped dimension (the P2P step's peers) into the batch, so each launch
sees plain tensors. Outside ``torch.inference_mode()`` its forward also
returns what the backward reads: o in f32 and each row's log-sum-exp
``lse`` (B, H, Sq) f32 of its masked, softcapped scores. On CPU tensors the
forward is ``flash_attention_plain`` (with ``flash_attention_stats_plain``)
and the backward ``flash_attention_backward_plain``, which computes the
statistics again; ``flash_attention_backward_saved_plain`` is the bf16
backward kernels' plain twin, from the saved lse. On CUDA tensors
both are the kernels, or raise: there is no fallback. On meta tensors (the
dry run) both allocate what the kernels would and charge
``flash_attention_cost`` / ``flash_attention_backward_cost``, the
formulas of the kernels' bounds, without a launch.

``attend`` is the port's copy of the reference's ``models/layers.py:attend``
(masks from positions, ``finfo(f32).min`` as the mask value, a direct
softmax up to 1024 keys, an online softmax over blocks of 1024 beyond).
The models' decode calls it over the KV cache; ``flash_attention_plain``
calls it with ``arange`` positions. Each wrapper counts its kernel
launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.cost import (  # noqa: F401 (valid_pairs: exported beside the wrappers)
    flash_attention_backward_cost,
    flash_attention_cost,
    valid_pairs,
)

SOURCE = "flash_attention.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
MAX_HEADDIM = 256  # what the kernel's shared-memory tiling takes (csrc/flash_attention.cu)
TMA_ALIGN = 16  # bytes: the bf16 body's TMA descriptors need this of base address and strides
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap else x


def attend(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, K, D)
    v: torch.Tensor,
    *,
    causal: bool,
    q_positions: torch.Tensor,  # (Sq,) absolute positions of the queries
    kv_positions: torch.Tensor,  # (Skv,) absolute positions of the keys (-1 = invalid)
    window: int = 0,
    softcap_val: float = 0.0,
    block_kv: int = 1024,
    scale=None,
) -> torch.Tensor:
    """Masked multi-head attention with GQA and online-softmax blocking
    (the reference's ``attend``). Validity and locality come from the
    positions alone, so one function serves full causal attention, sliding
    windows, rolling decode caches and cross attention (``causal=False``,
    where ``window`` bounds |q_pos - kv_pos|)."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"the {K} KV heads must divide the {H} query heads")
    G = H // K
    f32 = torch.promote_types(q.dtype, torch.float32)  # f32, or f64 for a gradient check
    qf = q.reshape(B, Sq, K, G, D).to(f32)
    qf = qf / math.sqrt(D) if scale is None else qf * scale
    mask_value = torch.finfo(f32).min

    def block(kb, kpos):
        s = softcap(torch.einsum("bqkgd,bskd->bkgqs", qf, kb.to(f32)), softcap_val)
        valid = (kpos >= 0)[None, :]
        if causal:
            rel = q_positions[:, None] - kpos[None, :]  # (Sq, Skv_b)
            ok = rel >= 0
            if window:
                ok &= rel < window
            valid = valid & ok
        elif window:
            valid = valid & ((q_positions[:, None] - kpos[None, :]).abs() < window)
        return torch.where(valid, s, mask_value)

    if Skv <= block_kv:
        p = torch.softmax(block(k, kv_positions), dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(f32))
        return o.reshape(B, Sq, H, D).to(q.dtype)

    # online softmax over key blocks (flash-style; memory O(block))
    nblocks = -(-Skv // block_kv)
    pad = nblocks * block_kv - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=-1)
    m = torch.full((B, K, G, Sq), -math.inf, dtype=f32, device=q.device)
    l = torch.zeros((B, K, G, Sq), dtype=f32, device=q.device)
    acc = torch.zeros((B, K, G, Sq, D), dtype=f32, device=q.device)
    for n in range(nblocks):
        sl = slice(n * block_kv, (n + 1) * block_kv)
        s = block(k[:, sl], kv_positions[sl])  # (B, K, G, Sq, block)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, v[:, sl].to(f32))
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, softcap: float = 0.0, window: int = 0, scale=None,
) -> torch.Tensor:
    """Plain PyTorch flash attention: ``attend`` at positions ``arange(Sq)``
    and ``arange(Skv)``, the window only when causal (the kernel's function)."""
    return attend(
        q, k, v, causal=causal,
        q_positions=torch.arange(q.shape[1], device=q.device),
        kv_positions=torch.arange(k.shape[1], device=k.device),
        window=window if causal else 0, softcap_val=softcap, scale=scale,
    )


def _scale(D: int, scale) -> float:
    return 1.0 / math.sqrt(D) if scale is None else scale


def _masked_scores(q, k, *, causal: bool, softcap: float, window: int, scale=None):
    """The kernels' scores, (B, K, G, Sq, Skv) in f32 (f64 for f64 inputs),
    -inf on the masked pairs, with t = tanh(u / softcap) (None without a
    softcap), the validity mask and q in f32 as (B, Sq, K, G, D)."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    f32 = torch.promote_types(q.dtype, torch.float32)  # f32, or f64 for a gradient check
    qf = q.reshape(B, Sq, K, H // K, D).to(f32)
    u = torch.einsum("bqkgd,bskd->bkgqs", qf * _scale(D, scale), k.to(f32))
    t = torch.tanh(u / softcap) if softcap else None
    s = softcap * t if softcap else u
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Skv, device=q.device)[None, :]
    valid = (i - j >= 0) & ((i - j < window) if window else True) if causal else (j >= 0)
    return torch.where(valid, s, -math.inf), t, valid, qf


def flash_attention_stats_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, softcap: float = 0.0, window: int = 0, scale=None,
):
    """Plain PyTorch version of what the forward kernel saves for the
    backward -> (o, lse): o = softmax(s) v in f32 (f64 for f64 inputs), (B,
    Sq, H, D), before the output's rounding, and lse_i = log sum_j exp(s_ij)
    over the valid keys, (B, H, Sq), over the whole (Sq, Skv) score matrix.
    A query row with no valid key gets o = 0 and lse = -inf, as the kernel
    gives it."""
    B, Sq, H, D = q.shape
    s, _, valid, _ = _masked_scores(q, k, causal=causal, softcap=softcap, window=window,
                                    scale=scale)
    lse = torch.logsumexp(s, dim=-1)  # -inf on a row with no valid key
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(p.dtype))
    return o.reshape(B, Sq, H, D), lse.reshape(B, H, Sq)


def flash_attention_backward_saved_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
    causal: bool = True, softcap: float = 0.0, window: int = 0, scale=None,
):
    """Plain PyTorch backward in the bf16 kernels' form, from the forward's
    lse (B, H, Sq) -> (dq, dk, dv) in the dtypes of q, k and v, step by
    step in f32 (f64 for f64 inputs) over the whole (Sq, Skv) score matrix.

        u_ij  = (q_i scale) . k_j,  t_ij = tanh(u_ij / softcap)
        s_ij  = softcap * t_ij  (u_ij without softcap), masked as the forward
        p_ij  = exp(s_ij - lse_i) on the valid j, else 0
        dv_j  = sum_i p_ij do_i               dp_ij = do_i . v_j
        ds_ij = p_ij (dp_ij - delta_i),       delta_i = sum_j p_ij dp_ij / sum_j p_ij
        du_ij = ds_ij (1 - t_ij^2)            (ds_ij without softcap)
        dq_i  = sum_j du_ij k_j scale         dk_j = sum_i du_ij q_i scale

    delta_i is do_i . o_i; divided by the row's sum of p it carries no error
    of lse, which p shares along the row (an error of lse then scales each
    gradient of the row, where do_i . o_i from a saved o would add a term
    that dq's cancellation in dp - delta makes large). dk and dv sum over
    the H / K query heads of each KV group. A query row with no valid key
    gets zero gradient."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    s, t, valid, qf = _masked_scores(q, k, causal=causal, softcap=softcap, window=window,
                                     scale=scale)
    scale = _scale(D, scale)
    f32 = s.dtype
    kf, vf = k.to(f32), v.to(f32)
    dof = do.reshape(B, Sq, K, G, D).to(f32)
    p = torch.where(valid, torch.exp(s - lse.reshape(B, K, G, Sq, 1).to(f32)), 0.0)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    sum_p = p.sum(dim=-1, keepdim=True)
    delta = torch.where(sum_p > 0, (p * dp).sum(dim=-1, keepdim=True) / sum_p, 0.0)
    du = p * (dp - delta)
    if softcap:
        du = du * (1.0 - t * t)
    dq = torch.einsum("bkgqs,bskd->bqkgd", du, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", du, qf) * scale
    return dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *,
    causal: bool = True, softcap: float = 0.0, window: int = 0, scale=None,
):
    """Plain PyTorch backward of the kernels' function -> (dq, dk, dv) in
    the dtypes of q, k and v: the formula the backward kernels compute,
    step by step in f32 (f64 for f64 inputs) over the whole (Sq, Skv)
    score matrix, in one pass (the scores once; o and delta from p).

        u_ij  = (q_i scale) . k_j,  t_ij = tanh(u_ij / softcap)
        s_ij  = softcap * t_ij  (u_ij without softcap), masked as the forward
        p_ij  = exp(s_ij - lse_i) on the valid j, else 0
        dv_j  = sum_i p_ij do_i               dp_ij = do_i . v_j
        ds_ij = p_ij (dp_ij - delta_i),       delta_i = do_i . o_i, o_i = sum_j p_ij v_j
        du_ij = ds_ij (1 - t_ij^2)            (ds_ij without softcap)
        dq_i  = sum_j du_ij k_j scale         dk_j = sum_i du_ij q_i scale

    dk and dv sum over the H / K query heads of each KV group. A query row
    with no valid key gets zero gradient, as the kernel's forward gives it
    a zero output. ``flash_attention_backward_saved_plain`` is the same
    function from the forward's saved lse."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    s, t, valid, qf = _masked_scores(q, k, causal=causal, softcap=softcap, window=window,
                                     scale=scale)
    scale = _scale(D, scale)
    f32 = s.dtype
    kf, vf = k.to(f32), v.to(f32)
    dof = do.reshape(B, Sq, K, G, D).to(f32)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)  # a row with no valid key
    e = torch.where(valid, torch.exp(s - m), 0.0)
    p = e / torch.clamp_min(e.sum(dim=-1, keepdim=True), 1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
    delta = torch.einsum("bqkgd,bqkgd->bkgq", dof, o)[..., None]
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    du = p * (dp - delta)
    if softcap:
        du = du * (1.0 - t * t)
    dq = torch.einsum("bkgqs,bskd->bqkgd", du, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", du, qf) * scale
    return dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.flash_attention_launch.argtypes = [
        ptr, ptr, ptr, ptr,  # q, k, v, o
        ptr, ptr,  # lse (batch, heads, Sq) and o in f32, or null: bf16 only
        i32, i32, i32, i32, i32, i32, i32,  # batch, Sq, Skv, heads, kv heads, headdim, bf16
        i64, i64, i64,  # q strides (batch, seq, head)
        i64, i64, i64,  # k strides
        i64, i64, i64,  # v strides
        f32, f32, i32, i32,  # scale, softcap, causal, window
        ptr,  # stream
    ]
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load(BWD_SOURCE)
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.flash_attention_backward_launch.argtypes = [
        ptr, ptr, ptr,  # q, k, v
        ptr,  # the forward's lse: bf16 only
        ptr,  # do
        ptr, ptr, ptr,  # dq, dk, dv
        ptr,  # scratch: delta (bf16) or lse and delta (f32), (batch, heads, Sq) f32 each
        i32, i32, i32, i32, i32, i32, i32,  # batch, Sq, Skv, heads, kv heads, headdim, bf16
        i64, i64, i64,  # q strides (batch, seq, head)
        i64, i64, i64,  # k strides
        i64, i64, i64,  # v strides
        i64, i64, i64,  # do strides
        f32, f32, i32, i32,  # scale, softcap, causal, window
        ptr,  # stream
    ]
    lib.flash_attention_backward_launch.restype = ctypes.c_int
    return lib


def load_library() -> None:
    """Build and load the forward and backward kernels ahead of their
    first launch."""
    _lib()
    _bwd_lib()


def _check(q, k, v, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-d: (batch, seq, heads, headdim)")
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, K, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must both be "
                         f"(batch {B}, seq, kv heads, headdim {D})")
    if K == 0 or H % K:
        raise ValueError(f"the {K} KV heads must divide the {H} query heads")
    if Skv == 0:
        raise ValueError("attention needs at least one key")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one dtype of {list(_DTYPES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"window must be 0 (none) or positive, got {window}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one device")


def _check_launch(D: int, *tensors) -> None:
    """What both CUDA kernels need beyond ``_check``: a headdim that is a
    multiple of 32 up to 256 and a contiguous last dimension."""
    if D % 32 or D > MAX_HEADDIM:
        raise ValueError(f"the flash kernels take a headdim that is a multiple of 32 up to "
                         f"{MAX_HEADDIM}, got {D}")
    if not all(t.stride(-1) == 1 for t in tensors):
        raise ValueError("the flash kernels' inputs must be contiguous in their last dimension")


def _check_tma(q, k, v) -> None:
    """The bf16 body reads q, k and v through TMA descriptors: each base
    address, and the stride of each dimension longer than 1, must be a
    positive multiple of 16 bytes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        off = t.data_ptr() % TMA_ALIGN
        if off:
            raise ValueError(f"bf16 {name} must start on a {TMA_ALIGN}-byte boundary for the "
                             f"kernel's TMA loads; it starts {off} bytes past one")
        for dim in range(3):
            step = t.stride(dim) * t.element_size()
            if t.shape[dim] > 1 and (step <= 0 or step % TMA_ALIGN):
                raise ValueError(f"bf16 {name}'s stride in dimension {dim} must be a positive "
                                 f"multiple of {TMA_ALIGN} bytes for the kernel's TMA loads, "
                                 f"got {step} bytes")


def _no_stats(q) -> torch.Tensor:
    """The saved statistics of a forward that saves none: an empty tensor
    that folds and unfolds under ``vmap`` like a real one."""
    return q.new_empty((q.shape[0], 0), dtype=torch.float32)


def _forward(q, k, v, causal: bool, softcap: float, window: int, stats: bool, scale=None):
    """The forward on plain tensors -> (o, o32, lse): the plain version on
    the CPU, the kernel on CUDA. With ``stats`` also o in f32 (B, Sq, H, D)
    and lse (B, H, Sq), the backward's inputs (f64 for f64 inputs on the
    CPU); without, or for f32 on CUDA (the f32 backward recomputes its
    own), two empty tensors."""
    if q.device.type == "cpu":
        o = flash_attention_plain(q, k, v, causal=causal, softcap=softcap, window=window,
                                  scale=scale)
        if not stats:
            return o, _no_stats(q), _no_stats(q)
        return (o, *flash_attention_stats_plain(q, k, v, causal=causal, softcap=softcap,
                                                window=window, scale=scale))
    meta = build.on_meta(q)
    stream = None if meta else build.cuda_stream(q.device)
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    _check_launch(D, q, k, v)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_tma(q, k, v)
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    o32 = lse = _no_stats(q)
    if stats and bf16:
        o32 = torch.empty((B, Sq, H, D), dtype=torch.float32, device=q.device)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, o32, lse
    if not meta:
        with torch.cuda.device(q.device):
            err = _lib().flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr() if lse.numel() else None, o32.data_ptr() if o32.numel() else None,
                B, Sq, Skv, H, K, D, _DTYPES[q.dtype],
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                _scale(D, scale), float(softcap), int(causal), int(window), stream,
            )
        if err:
            raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
        flash_attention.launches += 1
    build.charge("flash_attention", *flash_attention_cost(q, k, causal=causal, window=window,
                                                          stats=o32.numel() > 0))
    return o, o32, lse


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its backward, in the ``setup_context`` form
    that ``torch.func`` transforms take. It returns (o, o32, lse): o32 (o
    in f32) and lse are marked non-differentiable and saved, with q, k and
    v, for the backward; under ``torch.inference_mode()`` (scoring, serve)
    the forward computes neither. Its ``vmap`` rule folds the vmapped
    dimension into the batch: a kernel that reads ``data_ptr()`` cannot see
    a batched tensor, so ``generate_vmap_rule`` would not do."""

    @staticmethod
    def forward(q, k, v, causal, softcap, window, scale=None):
        return _forward(q, k, v, causal, softcap, window,
                        stats=not torch.is_inference_mode_enabled(), scale=scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, softcap, window, *scale = inputs
        _, o32, lse = output
        ctx.mark_non_differentiable(o32, lse)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.opts = (causal, softcap, window, *scale)

    @staticmethod
    def backward(ctx, do, _do32, _dlse):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = FlashAttentionBackwardFn.apply(q, k, v, o32, lse, do, *ctx.opts)
        return (dq, dk, dv) + (None,) * len(ctx.opts)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, softcap, window, scale=None):
        outs = FlashAttentionFn.apply(*build.fold(info, in_dims[:3], (q, k, v)), causal, softcap,
                                      window, scale)
        return build.unfold(info, outs), (0, 0, 0)


class FlashAttentionBackwardFn(torch.autograd.Function):
    """The backward as a function of (q, k, v, o32, lse, do), so that it too
    runs under ``vmap`` with the vmapped dimension folded into the batch. It
    has no backward of its own: a second derivative raises."""

    @staticmethod
    def forward(q, k, v, o32, lse, do, causal, softcap, window, scale=None):
        return _backward(q, k, v, o32, lse, do, causal, softcap, window, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash_attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o32, lse, do, causal, softcap, window, scale=None):
        grads = FlashAttentionBackwardFn.apply(
            *build.fold(info, in_dims[:6], (q, k, v, o32, lse, do)), causal, softcap, window, scale)
        return build.unfold(info, grads), (0, 0, 0)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D) f32 or bf16
    k: torch.Tensor,  # (B, Skv, K, D), q's dtype
    v: torch.Tensor,  # (B, Skv, K, D), q's dtype
    *,
    causal: bool = True,
    softcap: float = 0.0,
    window: int = 0,
    scale=None,
) -> torch.Tensor:
    """Flash attention -> (B, Sq, H, D) in q's dtype, differentiable
    (:class:`FlashAttentionFn`). The inputs may be strided views as long as
    their last dimension is contiguous (in bf16 also with base addresses
    and strides on 16-byte boundaries, for the TMA loads); the kernel masks
    the ragged last tiles, where the TPU wrapper pads. The block sizes are
    the kernel's own: 64 queries by 64 keys in f32, 128 queries by 64 keys
    in bf16.

    A query row with no valid key (only when causal with a window and
    Sq > Skv + window - 1, never on a model path) gets 0 from the kernel
    and zero gradient from both backwards; the plain forward gives it
    ``attend``'s uniform weights over the masked keys, and the Pallas
    kernel weight 1 on its first fully masked block. Such rows are outside
    the parity contract (ROADMAP.md, Queue 3)."""
    _check(q, k, v, window)
    return FlashAttentionFn.apply(q, k, v, bool(causal), float(softcap), int(window),
                                  None if scale is None else float(scale))[0]


flash_attention.launches = 0


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *,
    causal: bool = True, softcap: float = 0.0, window: int = 0, scale=None,
):
    """Backward of ``flash_attention`` at (q, k, v) for the output's
    cotangent ``do`` (q's shape and dtype) -> (dq, dk, dv) in the inputs'
    dtype. On CUDA in bf16 the forward runs first for the o in f32 and
    lse that the backward reads (one forward launch). On CPU tensors:
    ``flash_attention_backward_plain``.
    On CUDA in bf16: two launches on the tensor cores counted as one (dq,
    writing delta = dO . o into a (B, H, Sq) f32 scratch; then dk and dv),
    in f32 three on the CUDA cores (row statistics lse and delta with o
    recomputed, dq, then dk and dv; 8 B H Sq bytes of scratch). No atomics:
    the same inputs give the same bits. A build or launch failure raises."""
    _check(q, k, v, window)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must have q's shape {tuple(q.shape)}, dtype {q.dtype} and device, "
                         f"got {tuple(do.shape)} {do.dtype} on {do.device}")
    causal, softcap, window = bool(causal), float(softcap), int(window)
    scale = None if scale is None else float(scale)
    if q.device.type != "cpu" and q.dtype == torch.bfloat16:
        _, o32, lse = _forward(q, k, v, causal, softcap, window, stats=True, scale=scale)
    else:
        o32 = lse = _no_stats(q)  # the f32 body and the plain backward recompute them
    return _backward(q, k, v, o32, lse, do, causal, softcap, window, scale)


flash_attention_backward.launches = 0


def _backward(q, k, v, o32, lse, do, causal: bool, softcap: float, window: int, scale=None):
    """The backward on plain tensors: on the CPU the plain version, which
    computes the scores once and needs neither o32 nor lse; on CUDA the
    kernel, which in bf16 reads the forward's lse (not o32: it takes each
    row's delta from p and dP)."""
    B, Sq, H, D = q.shape
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, do, causal=causal, softcap=softcap,
                                              window=window, scale=scale)
    if q.dtype == torch.bfloat16 and tuple(lse.shape) != (B, H, Sq):
        raise RuntimeError("flash_attention's bf16 backward needs the forward's lse: the "
                           "forward ran under torch.inference_mode(), which saves none")
    meta = build.on_meta(q)
    stream = None if meta else build.cuda_stream(q.device)
    Skv, K = k.shape[1], k.shape[2]
    _check_launch(D, q, k, v, do)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        if not (lse.dtype == torch.float32 and lse.is_contiguous()):
            raise ValueError("the bf16 backward reads lse as a contiguous f32 tensor")
        _check_tma(q, k, v)
        if not do.is_contiguous() or do.data_ptr() % TMA_ALIGN:
            do = do.clone(memory_format=torch.contiguous_format)  # TMA-ready rows
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Skv, K, D), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    scratch = torch.empty((1 if bf16 else 2, B, H, Sq), dtype=torch.float32, device=q.device)
    if not meta:
        with torch.cuda.device(q.device):
            err = _bwd_lib().flash_attention_backward_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr() if bf16 else None,
                do.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
                B, Sq, Skv, H, K, D, _DTYPES[q.dtype],
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
                _scale(D, scale), float(softcap), int(causal), int(window), stream,
            )
        if err:
            raise RuntimeError(f"flash_attention_backward kernel launch failed: cudaError {err}")
        flash_attention_backward.launches += 1
    build.charge("flash_attention_backward",
                 *flash_attention_backward_cost(q, k, causal=causal, window=window))
    return dq, dk, dv
