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
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.cost import ssd_scan_cost

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
        ptr,  # stream
    ]
    lib.ssd_scan_launch.restype = ctypes.c_int
    return lib


def load_library() -> None:
    """Build and load the kernel ahead of its first launch."""
    _lib()


def _check(x, dt, A, Bm, Cm, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError("x, dt, A, B, C must be 4-, 3-, 1-, 4- and 4-d")
    Bsz, S, H, _ = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} and A {tuple(A.shape)} must be "
                         f"{(Bsz, S, H)} and {(H,)}")
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
    meta = build.on_meta(x)
    stream = None if meta else build.cuda_stream(x.device)
    _check_launchable(x, Bm, Cm, chunk)
    if not all(t.stride(-1) == 1 for t in (x, Bm, Cm)) or A.stride(0) != 1:
        raise ValueError("x, B, C and A must be contiguous in their last dimension")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    states = decay = split = None
    if x.dtype == torch.bfloat16:
        # one buffer: the chunk states s_c (B, chunks, H, P, N) f32, their
        # decays (B, chunks, H) f32, the entering states R_c as bf16 hi and
        # lo (B, chunks, H, 2, P, N), each part 256-byte aligned
        n_states, n_decay = Bsz * -(-S // chunk) * H * P * N, Bsz * -(-S // chunk) * H
        split_at = -(-(4 * n_states + 4 * n_decay) // 256) * 256
        scratch = torch.empty(split_at + 4 * n_states, dtype=torch.uint8, device=x.device)
        states = scratch.data_ptr()
        decay, split = states + 4 * n_states, states + split_at
    if not meta:
        with torch.cuda.device(x.device):
            err = _lib().ssd_scan_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                y.data_ptr(), states, decay, split, Bsz, S, H, P, G, N, chunk, _DTYPES[x.dtype],
                *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3], stream,
            )
        if err:
            raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
        ssd_scan.launches += 1
    build.charge("ssd_scan", *ssd_scan_cost(x, Bm))
    return y


ssd_scan.launches = 0
