"""Mamba-2 chunked SSD scan: a CUDA kernel for Hopper beside its plain
PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py:ssd_scan_pallas``
(``_ssd_kernel``). The CUDA source is ``csrc/ssd_scan.cu``; its header says
what bounds the kernel on the card and how each of its two bodies works.

Per chunk of Q steps, for each (batch, head):

    cum   = cumsum(dt * A)                                    (Q,)
    L     = exp(where(i >= j, cum_i - cum_j, -inf))           (Q, Q)
    y     = ((C B^T) o L) (x dt) + (C state^T) o exp(cum)     (Q, P)
    state = state exp(cum_Q) + ((x dt) o exp(cum_Q - cum))^T B  (P, N)

with head h reading group h // (H / G) of B and C. The output is y
(B, S, H, P) float32; the final state is not returned, as in Pallas.

The kernel has two bodies, chosen by the type of x, B and C. bf16 runs
three chunk-parallel passes on the tensor cores (the chunks' end states,
the carry over the chunks, the outputs) through a scratch that the wrapper
allocates: the chunk states (B, chunks, H, P, N) in f32, their decays, and
the entering states as bf16 hi and lo halves (B, chunks, H, 2, P, N); f32 runs
one CUDA-core block per (batch, head) that walks its chunks in order.
Neither stands in for the other, and each refuses (``ValueError``, before
any launch) the shapes it does not take.

The plain version is ``ssd_chunked``, the port's copy of the reference's
``models/ssm.py:ssd_chunked``; the model's prefill calls it too, for the
final state. A wrapper takes its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel, or raises: there is no fallback. For a meta
tensor (the dry run) it allocates y and the scratch and charges
``ssd_scan_cost``, the formula of the kernel's bound, without a launch. The
wrapper counts its calls that launch the kernel in its ``launches``
attribute: one per call, though the bf16 body's call is three launches.

``ssd_scan`` has no backward, as the Pallas scan has no gradient. The
training route is ``ssd_chunked_grad``: ``ssd_chunked``'s y as an autograd
Function whose forward is the same bf16 body, keeping the entering states
that its pass 2 writes, and whose backward is a kernel of its own
(``csrc/ssd_scan_bwd.cu``, :class:`SsdChunkedBackwardFn`), both with
``vmap`` rules that fold the vmapped peers into the batch. On the CPU it is
``ssd_chunked`` under autograd.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.cost import ssd_scan_bwd_cost, ssd_scan_cost

SOURCE = "ssd_scan.cu"
# what each body's shared-memory tiling takes (csrc/ssd_scan.cu): the f32
# body (multiples of 4) and the bf16 body (multiples of 8, 16-byte rows)
MAX_HEADDIM = 128
MAX_STATE = 128
MAX_CHUNK = 1024
BF16_MAX_HEADDIM = 64
BF16_MAX_STATE = 128
BF16_MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) (post-softplus)
    A: torch.Tensor,  # (H,) negative decay rates
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in f32 (the reference's ``models/ssm.py:ssd_chunked``),
    all chunks at once and then a scan over the chunk states. Returns (y (B, S, H, P), final_state (B, H, P, N))."""
    Bsz, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    pad = (-S) % chunk
    f32 = torch.float32
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // chunk

    xc = x.reshape(Bsz, nc, chunk, H, Pd).to(f32)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, chunk, G, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, chunk, G, N).to(f32)

    a = dtc * A.to(f32)  # (B, nc, Q, H) log-decay per step
    cum = torch.cumsum(a, dim=2)  # inclusive within the chunk
    # L[i, j] = exp(cum_i - cum_j) for i >= j, masked before the exp
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q, Q, H)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    L = torch.exp(torch.where(causal, diff, float("-inf")))

    xdt = xc * dtc[..., None]  # (B, nc, Q, H, P)
    Bh = Bc.repeat_interleave(rep, dim=3)  # (B, nc, Q, H, N)
    Ch = Cc.repeat_interleave(rep, dim=3)

    scores = torch.einsum("bnqhk,bnshk->bnqsh", Ch, Bh) * L  # (B, nc, Q, Q, H)
    y_diag = torch.einsum("bnqsh,bnshp->bnqhp", scores, xdt)

    # per-chunk end states: S_n = sum_j exp(cum_last - cum_j) B_j x_j dt_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, Q, H)
    states = torch.einsum("bnqhk,bnqh,bnqhp->bnhpk", Bh, decay_to_end, xdt)

    # inter-chunk recurrence over the chunk states
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)
    R = init_state.to(f32) if init_state is not None else torch.zeros(
        (Bsz, H, Pd, N), dtype=f32, device=x.device)
    entering = []
    for n in range(nc):
        entering.append(R)  # the state entering chunk n
        R = R * chunk_decay[:, n, :, None, None] + states[:, n]
    entering = torch.stack(entering, dim=1)  # (B, nc, H, P, N)

    # off-diagonal contribution: C_i . (exp(cum_i) R_entering)
    decay_from_start = torch.exp(cum)  # (B, nc, Q, H)
    y_off = torch.einsum("bnqhk,bnhpk,bnqh->bnqhp", Ch, entering, decay_from_start)

    y = (y_diag + y_off).reshape(Bsz, Sp, H, Pd)[:, :S]
    return y, R


def ssd_scan_plain(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    *,
    chunk: int,
) -> torch.Tensor:
    """Plain PyTorch SSD scan -> y (B, S, H, P) f32: ``ssd_chunked``'s y,
    the kernel's function without the final state."""
    return ssd_chunked(x, dt, A, Bm, Cm, chunk)[0]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # x, dt, A, B, C, y
        ptr, ptr, ptr,  # the bf16 body's scratch: chunk states, decays, split entering states
        i32, i32, i32, i32, i32, i32, i32, i32,  # batch, seq, heads, headdim, groups, state, chunk, bf16
        i64, i64, i64,  # x strides (batch, seq, head)
        i64, i64, i64,  # dt strides
        i64, i64, i64,  # B strides (batch, seq, group)
        i64, i64, i64,  # C strides
        i64,  # A's stride between batch rows (0: one A for all)
        ptr,  # stream
    ]
    lib.ssd_scan_launch.restype = ctypes.c_int
    return lib


def load_library() -> None:
    """Build and load the kernel ahead of its first launch."""
    _lib()


def _check(x, dt, A, Bm, Cm, chunk: int, rows_of_A: bool = False) -> None:
    """The inputs' shapes, dtypes and device; ``rows_of_A``: A may also be
    (n, H), one row for each of n equal runs of the batch (the training
    route's ``vmap`` rules fold a per-peer A so)."""
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError("x, dt, B, C must be 4-, 3-, 4- and 4-d")
    Bsz, S, H, _ = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rows = rows_of_A and A.dim() == 2 and A.shape[1] == H and A.shape[0] and Bsz % A.shape[0] == 0
    if tuple(dt.shape) != (Bsz, S, H) or (tuple(A.shape) != (H,) and not rows):
        raise ValueError(f"dt {tuple(dt.shape)} and A {tuple(A.shape)} must be "
                         f"{(Bsz, S, H)} and {(H,)}"
                         + (f" or (n, {H}) with n dividing {Bsz}" if rows_of_A else ""))
    if tuple(Bm.shape) != (Bsz, S, G, N) or Cm.shape != Bm.shape:
        raise ValueError(f"B {tuple(Bm.shape)} and C {tuple(Cm.shape)} must both be "
                         f"(batch {Bsz}, seq {S}, groups, state)")
    if G == 0 or H % G:
        raise ValueError(f"the {G} groups of B and C must divide the {H} heads")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, B and C must share one dtype of {list(_DTYPES)}, got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, got {dt.dtype} and {A.dtype}")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if not all(t.device == x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("x, dt, A, B and C must lie on one device")


def _check_launchable(x, Bm, Cm, chunk: int) -> None:
    """The shapes and layouts the CUDA kernel's body for x's type takes."""
    P, N = x.shape[3], Bm.shape[3]
    if x.dtype == torch.bfloat16:
        chunk_ok = chunk % 8 == 0 if chunk <= 64 else chunk % 64 == 0 and chunk <= BF16_MAX_CHUNK
        if P % 8 or N % 8 or P > BF16_MAX_HEADDIM or N > BF16_MAX_STATE or not chunk_ok:
            raise ValueError(
                f"the SSD kernel's bf16 body takes headdim and state that are multiples of 8, "
                f"at most {BF16_MAX_HEADDIM} and {BF16_MAX_STATE}, and a chunk that is a "
                f"multiple of 8 up to 64 or of 64 up to {BF16_MAX_CHUNK}; got {P}, {N}, {chunk}"
            )
        for name, t in (("x", x), ("B", Bm), ("C", Cm)):
            strides = [st for st, size in zip(t.stride()[:3], t.shape[:3]) if size > 1]
            if t.data_ptr() % 16 or any(st % 8 for st in strides):
                raise ValueError(
                    f"the SSD kernel's bf16 body loads 16-byte rows: {name}'s address and "
                    f"strides must be multiples of 16 bytes, got {t.data_ptr() % 16} past "
                    f"16 and strides {t.stride()}"
                )
        return
    if P % 4 or N % 4 or chunk % 4 or P > MAX_HEADDIM or N > MAX_STATE or chunk > MAX_CHUNK:
        raise ValueError(
            f"the SSD kernel takes headdim, state and chunk that are multiples of 4, at most "
            f"{MAX_HEADDIM}, {MAX_STATE} and {MAX_CHUNK}; got {P}, {N}, {chunk}"
        )


def _A_rows(A: torch.Tensor, batch: int) -> Tuple[torch.Tensor, int]:
    """A as the kernels read it -> (A, its stride between batch rows): an
    (H,) A is every row's (stride 0); an (n, H) A, n dividing the batch, is
    repeated to one row per batch row (stride H)."""
    if A.dim() == 1:
        return A, 0
    n, H = A.shape
    return A[:, None].expand(n, batch // n, H).reshape(batch, H).contiguous(), H


def _launch(x, dt, A, Bm, Cm, chunk: int, split: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward kernel on CUDA or meta tensors -> y (B, S, H, P) f32,
    after the launch checks; on meta, allocations only. In bf16 the entering
    states R_c go to ``split`` (B, chunks, H, 2, P, N) bf16 where given (the
    training route saves them), else to the scratch."""
    meta = build.on_meta(x)
    stream = None if meta else build.cuda_stream(x.device)
    _check_launchable(x, Bm, Cm, chunk)
    Bsz, S, H, P = x.shape
    A, a_sb = _A_rows(A, Bsz)
    if not all(t.stride(-1) == 1 for t in (x, Bm, Cm, A)):
        raise ValueError("x, B, C and A must be contiguous in their last dimension")
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    states = decay = split_ptr = None
    if x.dtype == torch.bfloat16:
        # one buffer: the chunk states s_c (B, chunks, H, P, N) f32, their
        # decays (B, chunks, H) f32, and unless ``split`` is given the
        # entering states R_c as bf16 hi and lo (B, chunks, H, 2, P, N), each
        # part 256-byte aligned
        n_states, n_decay = Bsz * -(-S // chunk) * H * P * N, Bsz * -(-S // chunk) * H
        split_at = -(-(4 * n_states + 4 * n_decay) // 256) * 256
        scratch = torch.empty(split_at + (0 if split is not None else 4 * n_states),
                              dtype=torch.uint8, device=x.device)
        states = scratch.data_ptr()
        decay = states + 4 * n_states
        split_ptr = split.data_ptr() if split is not None else states + split_at
    if not meta:
        with torch.cuda.device(x.device):
            err = _lib().ssd_scan_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                y.data_ptr(), states, decay, split_ptr, Bsz, S, H, P, G, N, chunk,
                _DTYPES[x.dtype], *x.stride()[:3], *dt.stride(), *Bm.stride()[:3],
                *Cm.stride()[:3], a_sb, stream,
            )
        if err:
            raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    return y


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P) f32 or bf16
    dt: torch.Tensor,  # (B, S, H) f32, after softplus
    A: torch.Tensor,  # (H,) f32, negative
    Bm: torch.Tensor,  # (B, S, G, N), x's dtype
    Cm: torch.Tensor,  # (B, S, G, N), x's dtype
    *,
    chunk: int = 256,
) -> torch.Tensor:
    """Chunked SSD scan -> y (B, S, H, P) f32. The sequence is masked to a
    whole number of chunks inside the kernel, where ``ssd_scan_pallas``
    pads it. The inputs may be strided views (the model passes slices of
    the convolution's output) as long as their last dimension is
    contiguous. bf16 inputs run the tensor-core body (three launches through
    a scratch of the chunk states, (B, chunks, H, P, N) in f32 and the same
    again as bf16 hi and lo halves), f32 inputs the CUDA-core body;
    ``launches`` counts one per call either way. On CUDA
    tensors there is no backward, as the reference's Pallas scan has no
    gradient (ROADMAP reference behaviour 18; LM training takes the chunked
    scan): with grad mode on and an input that requires grad it raises
    ``RuntimeError`` before any launch (``build.refuse_grad``); the CPU
    route differentiates."""
    _check(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    build.refuse_grad("ssd_scan", x, dt, A, Bm, Cm)
    y = _launch(x, dt, A, Bm, Cm, chunk)
    if not build.on_meta(x) and y.numel():
        ssd_scan.launches += 1
    build.charge("ssd_scan", *ssd_scan_cost(x, Bm))
    return y


ssd_scan.launches = 0


# -- the training route: the bf16 forward kernel and its backward kernel --------

BWD_SOURCE = "ssd_scan_bwd.cu"


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load(BWD_SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_backward_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # x, dt, A, B, C, dy, the saved entering states
        ptr, ptr, ptr, ptr, ptr,  # dx, ddt, dA, dB, dC
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # scratch (_grad_backward's order)
        i32, i32, i32, i32,  # batch, seq, heads, headdim
        i32, i32, i32, i32,  # groups, state, chunk, dA's groups of batch rows
        i64, i64, i64,  # x strides (batch, seq, head)
        i64, i64, i64,  # dt strides
        i64, i64, i64,  # B strides (batch, seq, group)
        i64, i64, i64,  # C strides
        i64,  # A's stride between batch rows (0: one A for all)
        ptr,  # stream
    ]
    lib.ssd_scan_backward_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _grad_libs() -> None:
    """Both libraries of the training route, built in parallel (one ``nvcc``
    each) at its first forward, and loaded."""
    build.build_all([SOURCE, BWD_SOURCE])
    _lib()
    _bwd_lib()


def ssd_grad_takes(x, Bm, Cm, chunk: int) -> bool:
    """Whether the training route's kernels take these inputs: x on CUDA or
    meta, x, B and C in bf16 with headdim and state that are multiples of 8
    up to 64 and 128 (the bf16 body's), a chunk that is a multiple of 64 up to
    256, and rows the TMA loads take (last dimension contiguous, strides of
    16 bytes; a base address off 16 bytes is copied, ``_rows16``). It reads
    only what a tensor under ``torch.func`` transforms shows."""
    if x.device.type not in ("cuda", "meta") or x.dim() != 4 or Bm.dim() != 4 or Cm.dim() != 4:
        return False
    if not all(t.dtype == torch.bfloat16 for t in (x, Bm, Cm)):
        return False
    P, N = x.shape[3], Bm.shape[3]
    if P % 8 or N % 8 or P > BF16_MAX_HEADDIM or N > BF16_MAX_STATE:
        return False
    if chunk <= 0 or chunk % 64 or chunk > BF16_MAX_CHUNK:
        return False
    return all(t.stride(-1) == 1 and all(st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3])
                                         if n > 1) for t in (x, Bm, Cm))


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy where its base address is off 16 bytes."""
    return t if build.on_meta(t) or t.data_ptr() % 16 == 0 else t.contiguous()


def _grad_forward(x, dt, A, Bm, Cm, chunk: int):
    """The training route's forward on plain tensors -> (y (B, S, H, P) f32,
    the entering states (B, chunks, H, 2, P, N) bf16 as hi and lo halves):
    the bf16 body's three passes, its pass 2 writing the states that the
    backward reads."""
    _check(x, dt, A, Bm, Cm, chunk, rows_of_A=True)
    if not ssd_grad_takes(x, Bm, Cm, chunk):
        raise ValueError("ssd_chunked_grad's kernels take bf16 x, B and C with headdim and state "
                         "multiples of 8 up to 64 and 128, a chunk that is a multiple of 64 up to "
                         "256, and 16-byte rows")
    x, Bm, Cm = (_rows16(t) for t in (x, Bm, Cm))
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    split = torch.empty((Bsz, -(-S // chunk), H, 2, P, N), dtype=torch.bfloat16, device=x.device)
    if not build.on_meta(x):
        _grad_libs()
    y = _launch(x, dt, A, Bm, Cm, chunk, split=split)
    if not build.on_meta(x) and y.numel():
        ssd_chunked_grad.launches += 1
    build.charge("ssd_chunked_grad", *ssd_scan_cost(x, Bm))
    return y, split


def _grad_backward(x, dt, A, Bm, Cm, split, dy, chunk: int, groups: Optional[int] = None):
    """The backward kernel on plain tensors -> (dx, ddt, dA, dB, dC) in the
    inputs' dtypes. dA has A's shape, (H,) or (n, H) (``_A_rows``), or with
    ``groups`` given (groups, H): the sums over each of ``groups`` equal runs
    of the batch (the slices of a vmapped call). Seven launches, counted as
    one on ``ssd_chunked_grad_backward``; the scratch (ssd_scan_bwd.cu's
    launch function) is allocated here."""
    x, Bm, Cm = (_rows16(t) for t in (x, Bm, Cm))
    meta = build.on_meta(x)
    stream = None if meta else build.cuda_stream(x.device)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // chunk)
    if tuple(split.shape) != (Bsz, nc, H, 2, P, N) or not split.is_contiguous():
        raise ValueError(f"the saved states must be contiguous {(Bsz, nc, H, 2, P, N)}, "
                         f"got {tuple(split.shape)}")
    rows = groups if groups is not None else 1 if A.dim() == 1 else A.shape[0]
    if Bsz % rows:
        raise ValueError(f"{rows} groups must divide the batch of {Bsz}")
    dy = dy.to(torch.float32).contiguous()
    dev, f32 = x.device, torch.float32
    dx = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bsz, S, H), dtype=f32, device=dev)
    dA = torch.empty((rows, H), dtype=f32, device=dev)
    vector_dA = groups is None and A.dim() == 1
    A, a_sb = _A_rows(A, Bsz)
    dB = torch.empty((Bsz, S, G, N), dtype=Bm.dtype, device=dev)
    dC = torch.empty((Bsz, S, G, N), dtype=Cm.dtype, device=dev)
    scratch = [torch.empty(shape, dtype=f32, device=dev) for shape in (
        (Bsz, nc, H, P, N),  # direct: the state gradient each chunk's outputs give
        (Bsz, nc, H), (Bsz, nc, H), (Bsz, nc, H),  # decay, the chunk-end dcum, dA's shares
        (Bsz, S, H, N), (Bsz, S, H, N),  # dC and dB per head
        (Bsz, S, H))]  # dcum: the gradient of the within-chunk cumsum
    scratch.append(torch.empty_like(split))  # ds_c as bf16 hi and lo
    if not meta and dx.numel():
        with torch.cuda.device(dev):
            err = _bwd_lib().ssd_scan_backward_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                dy.data_ptr(), split.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                dB.data_ptr(), dC.data_ptr(), *(t.data_ptr() for t in scratch),
                Bsz, S, H, P, G, N, chunk, rows, *x.stride()[:3], *dt.stride(),
                *Bm.stride()[:3], *Cm.stride()[:3], a_sb, stream,
            )
        if err:
            raise RuntimeError(f"ssd_chunked_grad backward kernel launch failed: cudaError {err}")
        ssd_chunked_grad_backward.launches += 1
    build.charge("ssd_chunked_grad_backward", *ssd_scan_bwd_cost(x, Bm, chunk))
    return dx, ddt, dA[0] if vector_dA else dA, dB, dC


def _fold_A(info, in_dim, A: torch.Tensor) -> torch.Tensor:
    """A under ``vmap`` -> the rows the kernels read for the folded batch:
    an unbatched (H,) stays one row for all; otherwise each slice's rows in
    turn, (slices x n, H), as ``build.fold`` orders the batch (a per-peer
    A: a banked step's, or one a nested rule folded)."""
    if in_dim is None and A.dim() == 1:
        return A
    A = A.expand(info.batch_size, *A.shape) if in_dim is None else A.movedim(in_dim, 0)
    return A.reshape(-1, A.shape[-1])


class SsdChunkedFn(torch.autograd.Function):
    """``ssd_chunked``'s y on the kernels, in the ``setup_context`` form that
    ``torch.func`` transforms take. It returns (y, the entering states as
    bf16 hi and lo): the states are marked non-differentiable and saved, with
    the inputs, for the backward. Its ``vmap`` rule folds the vmapped
    dimension into the batch (a kernel that reads ``data_ptr()`` cannot see a
    batched tensor), and a batched A into one row per slice (``_fold_A``),
    which the kernels read per batch row."""

    @staticmethod
    def forward(x, dt, A, Bm, Cm, chunk):
        return _grad_forward(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, A, Bm, Cm, chunk = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(x, dt, A, Bm, Cm, output[1])
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, dy, _dsplit):
        x, dt, A, Bm, Cm, split = ctx.saved_tensors
        grads = SsdChunkedBackwardFn.apply(x, dt, A, Bm, Cm, split, dy, ctx.chunk)
        return (*grads, None)

    @staticmethod
    def vmap(info, in_dims, x, dt, A, Bm, Cm, chunk):
        x, dt, Bm, Cm = build.fold(info, in_dims[:2] + in_dims[3:5], (x, dt, Bm, Cm))
        A = _fold_A(info, in_dims[2], A)
        return build.unfold(info, SsdChunkedFn.apply(x, dt, A, Bm, Cm, chunk)), (0, 0)


class SsdChunkedBackwardFn(torch.autograd.Function):
    """The backward as a function of (x, dt, A, B, C, the saved states, dy),
    so that it too runs under ``vmap`` with the vmapped dimension folded into
    the batch, one launch for all; dA then comes back per slice: the sums
    over ``groups`` equal runs of the folded batch. It has no backward of
    its own: a second derivative raises."""

    @staticmethod
    def forward(x, dt, A, Bm, Cm, split, dy, chunk, groups=None):
        return _grad_backward(x, dt, A, Bm, Cm, split, dy, chunk, groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("ssd_chunked_grad has no second derivative")

    @staticmethod
    def vmap(info, in_dims, x, dt, A, Bm, Cm, split, dy, chunk, groups=None):
        # each slice's dA has A's shape, (H,) or (n, H), or (groups, H)
        shape = [n for i, n in enumerate(A.shape) if i != in_dims[2]]
        rows = groups if groups is not None else shape[0] if len(shape) == 2 else 1
        x, dt, Bm, Cm, split, dy = build.fold(info, in_dims[:2] + in_dims[3:7],
                                              (x, dt, Bm, Cm, split, dy))
        A = _fold_A(info, in_dims[2], A)
        dx, ddt, dA, dB, dC = SsdChunkedBackwardFn.apply(x, dt, A, Bm, Cm, split.contiguous(), dy,
                                                         chunk, info.batch_size * rows)
        dA = dA.unflatten(0, (info.batch_size, rows))
        if groups is None and len(shape) == 1:
            dA = dA[:, 0]
        return (*build.unfold(info, (dx, ddt)), dA, *build.unfold(info, (dB, dC))), (0,) * 5


def ssd_chunked_grad(
    x: torch.Tensor,  # (B, S, H, P) bf16
    dt: torch.Tensor,  # (B, S, H) f32, after softplus
    A: torch.Tensor,  # (H,) f32, negative
    Bm: torch.Tensor,  # (B, S, G, N) bf16
    Cm: torch.Tensor,  # (B, S, G, N) bf16
    chunk: int,
) -> torch.Tensor:
    """``ssd_chunked``'s y (B, S, H, P) f32 with no initial state, for
    training: differentiable on every device. On the CPU it is the plain
    ``ssd_chunked`` under autograd. On CUDA (and meta: allocations and
    costs, no launch) :class:`SsdChunkedFn`: the bf16 forward kernel, which
    keeps its entering states for the backward kernel (``csrc/ssd_scan_bwd.cu``),
    both for the inputs ``ssd_grad_takes``. ``launches`` counts the forward
    calls that launch, ``ssd_chunked_grad_backward.launches`` the backward's."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, chunk)[0]
    return SsdChunkedFn.apply(x, dt, A, Bm, Cm, int(chunk))[0]


ssd_chunked_grad.launches = 0


def ssd_chunked_grad_backward(x, dt, A, Bm, Cm, dy, chunk: int):
    """The backward of ``ssd_chunked_grad`` at (x, dt, A, B, C) for the
    cotangent ``dy`` of y -> (dx, ddt, dA, dB, dC) in the inputs' dtypes. On
    CUDA the forward kernel runs first for the entering states that the
    backward kernel reads (counted on ``ssd_chunked_grad.launches``); on the
    CPU autograd of ``ssd_chunked``. The same inputs give the same bits: the
    kernels use no atomics."""
    if x.device.type == "cpu":
        leaves = [t.detach().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        with torch.enable_grad():
            y = ssd_chunked(*leaves, chunk)[0]
        return torch.autograd.grad(y, leaves, dy)
    _, split = _grad_forward(x, dt, A, Bm, Cm, chunk)
    return _grad_backward(x, dt, A, Bm, Cm, split, dy, chunk)


ssd_chunked_grad_backward.launches = 0
