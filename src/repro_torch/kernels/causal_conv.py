"""Mamba-2's depthwise causal conv1d with its bias and SiLU: a CUDA kernel
pair for Hopper beside the plain PyTorch version.

Replaces no TPU kernel: the reference computes ``_causal_conv`` in plain
JAX (``repro/models/ssm.py``) and trains through it with ``jax.grad``. The
CUDA source is ``csrc/causal_conv.cu``; its header says what bounds the
kernels on the card and how they work.

``causal_conv`` is the port's copy of the reference's function (K shifted
products added one at a time in x's dtype); ``mamba2_apply`` applies it,
its bias and ``F.silu`` wherever the kernels do not take the input (the
CPU, f32, prefill and decode). ``causal_conv_silu`` is ``silu(causal_conv(x,
w, b))`` for training: on the CPU the plain function under autograd, on
CUDA (and meta: allocations and costs, no launch) :class:`CausalConvFn`,
whose forward kernel sums in f32 and rounds y to bf16 once, and whose
backward kernel (:class:`CausalConvBackwardFn`) recomputes the
pre-activation from the saved x, w and b and writes dx in bf16 and dw and
db summed in f32, in a fixed order. Both have ``vmap`` rules that fold the
vmapped peers into the batch, and a vmapped w or b (a banked step's) into
one row per slice, which the kernels read per batch row. ``launches``
counts the forward calls that launch, ``causal_conv_silu_backward.launches``
the backward's (two launches, counted as one).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.cost import causal_conv_bwd_cost, causal_conv_cost

SOURCE = "causal_conv.cu"
MAX_TAPS = 4
# csrc/causal_conv.cu: the backward's blocks each take kWarps x kBwdRun
# timesteps of a sequence, and leave one partial of dw and db each
_BWD_BLOCK_STEPS = 4 * 64


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. x: (B, S, C); w: (K, C). K shifted products
    added one at a time in x's dtype, one rounding per step, as the
    reference does (``F.conv1d`` would sum in f32 and round once)."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i : i + x.shape[1], :] * w[i]
    return out + b


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.causal_conv_fwd_launch.argtypes = [
        ptr, ptr, ptr, ptr,  # x, w, b, y
        i32, i32, i32, i32,  # batch, seq, channels, taps
        i64, i64, i64, i64,  # x's strides (batch, seq), w's and b's between batch rows
        ptr,  # stream
    ]
    lib.causal_conv_bwd_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # x, w, b, dy, dx
        ptr, ptr,  # the blocks' partials of dw and db, their sums (groups, K + 1, C) f32
        i32, i32, i32, i32, i32,  # batch, groups, seq, channels, taps
        i64, i64, i64, i64,  # x's strides (batch, seq), w's and b's between batch rows
        ptr,  # stream
    ]
    lib.causal_conv_fwd_launch.restype = ctypes.c_int
    lib.causal_conv_bwd_launch.restype = ctypes.c_int
    return lib


def load_library() -> None:
    """Build and load the kernels ahead of their first launch."""
    _lib()


def _rows_of(t: torch.Tensor, plain_dim: int) -> int:
    """How many rows of a weight ``t`` hold: 1 for a plain one (``plain_dim``
    dimensions), else its leading size."""
    return 1 if t.dim() == plain_dim else t.shape[0]


def _layout_ok(x: torch.Tensor, K: int) -> bool:
    """C a multiple of 4, 1 <= K <= 4, x's channels contiguous and its batch
    and row strides multiples of 8 bytes (4 bf16): the kernels move 4
    channels as one 8-byte vector."""
    return (x.shape[2] % 4 == 0 and 1 <= K <= MAX_TAPS and x.stride(2) == 1
            and all(st % 4 == 0 for st, n in zip(x.stride()[:2], x.shape[:2]) if n > 1))


def conv_takes(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the kernels take these inputs: x (B, S, C) on CUDA or meta,
    x, w and b in bf16, w (K, C) with K <= 4 and b (C,), C a multiple of 4,
    x's channels contiguous and its batch and row strides multiples of 8
    bytes (x may be a strided view; a base address off 8 bytes is copied).
    It reads only what a tensor under ``torch.func`` transforms shows."""
    if x.device.type not in ("cuda", "meta") or x.dim() != 3 or w.dim() != 2 or b.dim() != 1:
        return False
    if not all(t.dtype == torch.bfloat16 for t in (x, w, b)):
        return False
    C, K = x.shape[2], w.shape[0]
    return tuple(w.shape) == (K, C) and tuple(b.shape) == (C,) and _layout_ok(x, K)


def _check(x, w, b) -> None:
    """The shapes, dtypes and layout of a call on plain tensors: x (B, S, C);
    w (K, C) or (n, K, C) and b (C,) or (n', C), n and n' dividing the batch
    (one row a group of batch rows: the folded peers of a vmapped call)."""
    if x.dim() != 3 or w.dim() not in (2, 3) or b.dim() not in (1, 2):
        raise ValueError(f"x, w and b must be 3-, 2- or 3- and 1- or 2-d, got {x.dim()}, "
                         f"{w.dim()}, {b.dim()}")
    Bsz, _, C = x.shape
    K = w.shape[-2]
    rows = (_rows_of(w, 2), _rows_of(b, 1))
    if w.shape[-1] != C or b.shape[-1] != C or any(r <= 0 or Bsz % r for r in rows):
        raise ValueError(f"w {tuple(w.shape)} and b {tuple(b.shape)} must be (K, {C}) and "
                         f"({C},), or a row for each of n equal runs of the batch of {Bsz}")
    if max(rows) % min(rows):
        raise ValueError(f"w's {rows[0]} rows and b's {rows[1]} must divide one another")
    if not all(t.dtype == torch.bfloat16 for t in (x, w, b)):
        raise ValueError(f"the kernels take bf16 x, w and b, got {x.dtype}, {w.dtype}, {b.dtype}")
    if not all(t.device == x.device for t in (w, b)):
        raise ValueError("x, w and b must lie on one device")
    if not _layout_ok(x, K):
        raise ValueError(f"the causal conv kernels take x (B, S, C) with C a multiple of 4, its "
                         f"channels contiguous and 8-byte batch and row strides, and at most "
                         f"{MAX_TAPS} taps; got x {tuple(x.shape)} at strides {x.stride()}, K {K}")


def _per_batch_row(t: torch.Tensor, plain_dim: int, batch: int):
    """A weight as the kernels read it -> (tensor, its stride between batch
    rows): a plain one is every row's (stride 0); n rows, n dividing the
    batch, are repeated to one for each batch row."""
    if t.dim() == plain_dim:
        return t.contiguous(), 0
    n = t.shape[0]
    t = t[:, None].expand(n, batch // n, *t.shape[1:]).reshape(batch, *t.shape[1:]).contiguous()
    return t, t[0].numel()


def _rows8(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy where its base address is off 8 bytes."""
    return t if build.on_meta(t) or t.data_ptr() % 8 == 0 else t.contiguous()


def _forward(x, w, b) -> torch.Tensor:
    """The forward kernel on plain CUDA or meta tensors -> y (B, S, C) bf16;
    on meta, the same allocations and the cost, no launch."""
    _check(x, w, b)
    x = _rows8(x)
    K = w.shape[-2]
    w, w_sb = _per_batch_row(w, 2, x.shape[0])
    b, b_sb = _per_batch_row(b, 1, x.shape[0])
    y = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    if not build.on_meta(x) and y.numel():
        _launch_forward(x, w, w_sb, b, b_sb, y)
    build.charge("causal_conv_silu", *causal_conv_cost(x, K))
    return y


def _launch_forward(x, w, w_sb, b, b_sb, y) -> None:
    """One forward launch into ``y``, counted on ``causal_conv_silu``; w and
    b as ``_per_batch_row`` gives them."""
    Bsz, S, C = x.shape
    with torch.cuda.device(x.device):
        err = _lib().causal_conv_fwd_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), Bsz, S, C, w.shape[-2],
            *x.stride()[:2], w_sb, b_sb, build.cuda_stream(x.device))
    if err:
        raise RuntimeError(f"causal_conv_silu kernel launch failed: cudaError {err}")
    causal_conv_silu.launches += 1


def _backward(x, w, b, dy, groups=None):
    """The backward kernels on plain tensors -> (dx (B, S, C) bf16, dw, db).
    dw and db have w's and b's shapes, or with ``groups`` given (groups, K,
    C) and (groups, C): the sums over each of ``groups`` equal runs of the
    batch (the slices of a vmapped call). On meta, the same allocations and
    the cost, no launch."""
    _check(x, w, b)
    x = _rows8(x)
    Bsz, S, C = x.shape
    K = w.shape[-2]
    dw_shape, db_shape, dtypes = w.shape, b.shape, (w.dtype, b.dtype)
    rows_w, rows_b = _rows_of(w, 2), _rows_of(b, 1)
    rows = groups if groups is not None else max(rows_w, rows_b)
    if Bsz % rows:
        raise ValueError(f"{rows} groups must divide the batch of {Bsz}")
    w, w_sb = _per_batch_row(w, 2, Bsz)
    b, b_sb = _per_batch_row(b, 1, Bsz)
    dy = dy.to(torch.bfloat16).contiguous()
    dx = torch.empty((Bsz, S, C), dtype=torch.bfloat16, device=x.device)
    # the blocks' partials of dw and db, and their sums for each group
    part = torch.empty((Bsz * -(-S // _BWD_BLOCK_STEPS), K + 1, C), dtype=torch.float32,
                       device=x.device)
    sums = torch.empty((rows, K + 1, C), dtype=torch.float32, device=x.device)
    if not build.on_meta(x) and dx.numel():
        _launch_backward(x, w, w_sb, b, b_sb, dy, dx, part, sums)
    elif not dx.numel():
        sums.zero_()
    build.charge("causal_conv_silu_backward", *causal_conv_bwd_cost(x, K))
    dw, db = sums[:, :K], sums[:, K]
    if groups is None:
        dw = dw.unflatten(0, (rows_w, rows // rows_w)).sum(1).reshape(dw_shape)
        db = db.unflatten(0, (rows_b, rows // rows_b)).sum(1).reshape(db_shape)
    return dx, dw.to(dtypes[0]), db.to(dtypes[1])


def _launch_backward(x, w, w_sb, b, b_sb, dy, dx, part, sums) -> None:
    """The backward's two launches into ``dx`` and ``sums`` (groups, K + 1,
    C) f32 (dw's rows, then db's, for each of ``groups`` equal runs of the
    batch) through the scratch ``part``, counted as one on
    ``causal_conv_silu_backward``; w and b as ``_per_batch_row`` gives them."""
    Bsz, S, C = x.shape
    with torch.cuda.device(x.device):
        err = _lib().causal_conv_bwd_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            part.data_ptr(), sums.data_ptr(), Bsz, sums.shape[0], S, C, w.shape[-2],
            *x.stride()[:2], w_sb, b_sb, build.cuda_stream(x.device))
    if err:
        raise RuntimeError(f"causal_conv_silu backward kernel launch failed: cudaError {err}")
    causal_conv_silu_backward.launches += 1


def _fold_rows(info, in_dim, t: torch.Tensor, plain_dim: int) -> torch.Tensor:
    """A weight under ``vmap`` -> the rows the kernels read for the folded
    batch: an unbatched plain one stays one for all; otherwise each slice's
    rows in turn, (slices x n, ...), as ``build.fold`` orders the batch."""
    if in_dim is None and t.dim() == plain_dim:
        return t
    t = t.expand(info.batch_size, *t.shape) if in_dim is None else t.movedim(in_dim, 0)
    return t.reshape(-1, *t.shape[-plain_dim:])


def _slice_shape(t: torch.Tensor, in_dim) -> tuple:
    return tuple(n for i, n in enumerate(t.shape) if i != in_dim)


class CausalConvFn(torch.autograd.Function):
    """``silu(causal_conv(x, w, b))`` on the kernels, in the ``setup_context``
    form that ``torch.func`` transforms take; x, w and b are saved for the
    backward, nothing else. Its ``vmap`` rule folds the vmapped dimension
    into the batch, and a batched w or b into one row per slice."""

    @staticmethod
    def forward(x, w, b):
        return _forward(x, w, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        return CausalConvBackwardFn.apply(*ctx.saved_tensors, dy)

    @staticmethod
    def vmap(info, in_dims, x, w, b):
        x, = build.fold(info, in_dims[:1], (x,))
        w, b = _fold_rows(info, in_dims[1], w, 2), _fold_rows(info, in_dims[2], b, 1)
        return build.unfold(info, (CausalConvFn.apply(x, w, b),))[0], 0


class CausalConvBackwardFn(torch.autograd.Function):
    """The backward as a function of (x, w, b, dy), so that it too runs
    under ``vmap`` with the vmapped dimension folded into the batch, one
    call for all; dw and db then come back per slice: the sums over
    ``groups`` equal runs of the folded batch. It has no backward of its
    own: a second derivative raises."""

    @staticmethod
    def forward(x, w, b, dy, groups=None):
        return _backward(x, w, b, dy, groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("causal_conv_silu has no second derivative")

    @staticmethod
    def vmap(info, in_dims, x, w, b, dy, groups=None):
        w_shape, b_shape = _slice_shape(w, in_dims[1]), _slice_shape(b, in_dims[2])
        rows_w = groups or (w_shape[0] if len(w_shape) == 3 else 1)
        rows_b = groups or (b_shape[0] if len(b_shape) == 2 else 1)
        rows = max(rows_w, rows_b)
        x, dy = build.fold(info, (in_dims[0], in_dims[3]), (x, dy))
        w, b = _fold_rows(info, in_dims[1], w, 2), _fold_rows(info, in_dims[2], b, 1)
        dx, dw, db = CausalConvBackwardFn.apply(x, w, b, dy, info.batch_size * rows)
        dw = dw.unflatten(0, (info.batch_size, rows_w, rows // rows_w)).sum(2)
        db = db.unflatten(0, (info.batch_size, rows_b, rows // rows_b)).sum(2)
        if groups is None and len(w_shape) == 2:
            dw = dw[:, 0]
        if groups is None and len(b_shape) == 1:
            db = db[:, 0]
        return (build.unfold(info, (dx,))[0], dw, db), (0, 0, 0)


def causal_conv_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``silu(causal_conv(x, w, b))`` (B, S, C) in x's dtype, differentiable
    on every device. On the CPU it is the plain function under autograd; on
    CUDA (and meta) :class:`CausalConvFn`, for the inputs ``conv_takes``."""
    if x.device.type == "cpu":
        return F.silu(causal_conv(x, w, b))
    return CausalConvFn.apply(x, w, b)


causal_conv_silu.launches = 0


def causal_conv_silu_backward(x, w, b, dy):
    """The backward of ``causal_conv_silu`` at (x, w, b) for the cotangent
    ``dy`` -> (dx, dw, db) in the inputs' dtypes: on CUDA the backward
    kernels, which read x, w and b alone; on the CPU autograd of the plain
    function. The same inputs give the same bits: the kernels use no
    atomics."""
    if x.device.type == "cpu":
        leaves = [t.detach().requires_grad_(True) for t in (x, w, b)]
        with torch.enable_grad():
            y = F.silu(causal_conv(*leaves))
        return torch.autograd.grad(y, leaves, dy)
    return _backward(x, w, b, dy)


causal_conv_silu_backward.launches = 0
