"""QSGD quantize / dequantize / dequantize-and-reduce: CUDA kernels for
Hopper beside their plain PyTorch versions.

Replaces the Pallas TPU kernels ``repro/kernels/qsgd.py:qsgd_quantize``
(``_quantize_kernel``), ``qsgd_dequantize`` (``_dequantize_kernel``) and
``qsgd_dequant_reduce`` (``_dequant_reduce_kernel``).
The CUDA source is ``csrc/qsgd.cu``; its header says what bounds the
kernels on the card (device memory) and why they are shaped as they are.

A wrapper takes its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel, or raises: there is no fallback. Each
wrapper counts its kernel launches in its ``launches`` attribute, so a run
can show that the main path went through the kernel. For a meta tensor (the
dry run) a wrapper allocates its outputs and charges its ``*_cost``, the
formula of the kernel's bound, without a launch.

The uniforms ``u`` are an operand, as in the reference: the kernel draws
no random numbers, so the kernel and the plain version give the same
levels for the same inputs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cost import (
    qsgd_dequant_reduce_cost,
    qsgd_dequantize_cost,
    qsgd_quantize_cost,
)

SOURCE = "qsgd.cu"


def quantize_plain(
    buckets: torch.Tensor, u: torch.Tensor, s: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch QSGD: (nb, B) f32 buckets and uniforms -> int8 levels
    (nb, B) and f32 row norms (nb,), in the reference's operation order."""
    norms = torch.sqrt(torch.sum(buckets * buckets, dim=-1))
    safe = torch.clamp_min(norms, 1e-30)[:, None]
    r = buckets.abs() / safe * s
    l = torch.floor(r)
    xi = l + (u < r - l).to(torch.float32)
    lev = torch.clamp(xi, 0, s) * torch.sign(buckets)
    return lev.to(torch.int8), norms


def dequantize_plain(levels: torch.Tensor, norms: torch.Tensor, s: int) -> torch.Tensor:
    """Plain PyTorch ``levels * (norm / s)`` -> (nb, B) f32."""
    # Divide by a tensor: PyTorch may turn division by a Python scalar into
    # a multiplication by its reciprocal on CUDA, one rounding away from the
    # reference's true division.
    scale = norms / torch.full_like(norms, float(s))
    return levels.to(torch.float32) * scale[:, None]


def dequant_reduce_plain(
    levels: torch.Tensor, norms: torch.Tensor, w: torch.Tensor, s: int
) -> torch.Tensor:
    """Plain PyTorch ``sum_p w[p] * levels[p] * norms[p] / s`` -> (nb, B) f32,
    in the Pallas kernel's order: ``scale = (w * norm) / s`` first, then the
    products, summed p = 0 .. P-1 one after another."""
    scale = (w[:, None] * norms) / torch.full_like(norms, float(s))
    out = torch.zeros(levels.shape[1:], dtype=torch.float32, device=levels.device)
    for p in range(levels.shape[0]):
        out = out + levels[p].to(torch.float32) * scale[p][:, None]
    return out


def _check_levels(s: int) -> None:
    if not 1 <= int(s) <= 127:
        raise ValueError(f"QSGD levels s must be in [1, 127] to fit int8, got {s}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.qsgd_quantize_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.qsgd_quantize_launch.restype = ctypes.c_int
    lib.qsgd_dequantize_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.qsgd_dequantize_launch.restype = ctypes.c_int
    lib.qsgd_dequant_reduce_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.qsgd_dequant_reduce_launch.restype = ctypes.c_int
    return lib


def _vectorizable(bucket: int, *tensors: torch.Tensor) -> int:
    """1 when every row is a whole number of 4-element vectors and each
    tensor starts 16-byte aligned, so the kernel may use vector loads."""
    return int(bucket % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def load_library() -> None:
    """Build and load the kernels ahead of their first launch."""
    _lib()


def qsgd_quantize(
    buckets: torch.Tensor, u: torch.Tensor, s: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """buckets, u: (nb, B) f32 -> (levels int8 (nb, B), norms f32 (nb,))."""
    build.check_tensor(buckets, "buckets", torch.float32, 2)
    build.check_tensor(u, "u", torch.float32, 2)
    _check_levels(s)
    if u.shape != buckets.shape or u.device != buckets.device:
        raise ValueError(
            f"u {tuple(u.shape)} on {u.device} must match buckets "
            f"{tuple(buckets.shape)} on {buckets.device}"
        )
    if buckets.device.type == "cpu":
        return quantize_plain(buckets, u, s)
    meta = build.on_meta(buckets)
    stream = None if meta else build.cuda_stream(buckets.device)
    nb, bucket = buckets.shape
    levels = torch.empty((nb, bucket), dtype=torch.int8, device=buckets.device)
    norms = torch.empty((nb,), dtype=torch.float32, device=buckets.device)
    if nb == 0 or bucket == 0:
        return levels, norms.zero_()
    if not meta:
        with torch.cuda.device(buckets.device):
            err = _lib().qsgd_quantize_launch(
                buckets.data_ptr(), u.data_ptr(), levels.data_ptr(), norms.data_ptr(),
                nb, bucket, float(s), _vectorizable(bucket, buckets, u, levels), stream,
            )
        if err:
            raise RuntimeError(f"qsgd_quantize kernel launch failed: cudaError {err}")
        qsgd_quantize.launches += 1
    build.charge("qsgd_quantize", *qsgd_quantize_cost(nb, bucket))
    return levels, norms


qsgd_quantize.launches = 0


def qsgd_dequantize(levels: torch.Tensor, norms: torch.Tensor, s: int) -> torch.Tensor:
    """levels (nb, B) int8, norms (nb,) f32 -> f32 (nb, B)."""
    build.check_tensor(levels, "levels", torch.int8, 2)
    build.check_tensor(norms, "norms", torch.float32, 1)
    _check_levels(s)
    if norms.shape[0] != levels.shape[0] or norms.device != levels.device:
        raise ValueError(
            f"norms {tuple(norms.shape)} on {norms.device} must hold one norm "
            f"per row of levels {tuple(levels.shape)} on {levels.device}"
        )
    if levels.device.type == "cpu":
        return dequantize_plain(levels, norms, s)
    meta = build.on_meta(levels)
    stream = None if meta else build.cuda_stream(levels.device)
    nb, bucket = levels.shape
    out = torch.empty((nb, bucket), dtype=torch.float32, device=levels.device)
    if nb == 0 or bucket == 0:
        return out
    if not meta:
        with torch.cuda.device(levels.device):
            err = _lib().qsgd_dequantize_launch(
                levels.data_ptr(), norms.data_ptr(), out.data_ptr(),
                nb, bucket, float(s), _vectorizable(bucket, levels, out), stream,
            )
        if err:
            raise RuntimeError(f"qsgd_dequantize kernel launch failed: cudaError {err}")
        qsgd_dequantize.launches += 1
    build.charge("qsgd_dequantize", *qsgd_dequantize_cost(nb, bucket))
    return out


qsgd_dequantize.launches = 0


def qsgd_dequant_reduce(
    levels: torch.Tensor, norms: torch.Tensor, w: torch.Tensor, s: int
) -> torch.Tensor:
    """levels (P, nb, B) int8, norms (P, nb) f32, mixing weights w (P,) f32
    -> f32 (nb, B) = sum_p w[p] * dequantize(levels[p], norms[p])."""
    build.check_tensor(levels, "levels", torch.int8, 3)
    build.check_tensor(norms, "norms", torch.float32, 2)
    build.check_tensor(w, "w", torch.float32, 1)
    _check_levels(s)
    peers, nb, bucket = levels.shape
    if tuple(norms.shape) != (peers, nb) or tuple(w.shape) != (peers,) or not (
        norms.device == w.device == levels.device
    ):
        raise ValueError(
            f"norms {tuple(norms.shape)} on {norms.device} and w {tuple(w.shape)} "
            f"on {w.device} must be ({peers}, {nb}) and ({peers},) on {levels.device}"
        )
    if levels.device.type == "cpu":
        return dequant_reduce_plain(levels, norms, w, s)
    meta = build.on_meta(levels)
    stream = None if meta else build.cuda_stream(levels.device)
    out = torch.empty((nb, bucket), dtype=torch.float32, device=levels.device)
    if nb == 0 or bucket == 0 or peers == 0:
        return out.zero_()
    if not meta:
        with torch.cuda.device(levels.device):
            err = _lib().qsgd_dequant_reduce_launch(
                levels.data_ptr(), norms.data_ptr(), w.data_ptr(), out.data_ptr(), peers,
                nb, bucket, float(s), _vectorizable(bucket, levels, out), stream,
            )
        if err:
            raise RuntimeError(f"qsgd_dequant_reduce kernel launch failed: cudaError {err}")
        qsgd_dequant_reduce.launches += 1
    build.charge("qsgd_dequant_reduce", *qsgd_dequant_reduce_cost(peers, nb, bucket))
    return out


qsgd_dequant_reduce.launches = 0
