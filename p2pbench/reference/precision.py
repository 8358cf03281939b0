"""Operands of the reference's products in a stated precision.

``"f32"`` leaves them as they are. The controls round them to the next
precision below the configuration's, in the forward pass, with the
gradient passed straight through (the backward's products then take the
rounded saved operands and a float32 cotangent):

* ``"tf32"``: float32 with its mantissa rounded to TF32's 10 bits (round to
  nearest even), what the tensor cores read in TF32 mode;
* ``"fp8"``: float8 e4m3 with one scale per tensor (its largest magnitude
  maps to 448), as fp8 training recipes scale.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

PRECISIONS = ("f32", "tf32", "fp8")
FP8_MAX = 448.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.detach()
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a product reads it in ``precision`` (straight-through)."""
    if precision == "f32":
        return x
    rounded = _tf32(x) if precision == "tf32" else _fp8(x)
    return x + (rounded - x).detach()


def check(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """Float32 products at full precision on the card for its duration
    (TF32 off for matrix products and cuDNN), the flags restored after."""
    flags = [(torch.backends.cuda.matmul, "allow_tf32"), (torch.backends.cudnn, "allow_tf32")]
    saved = [getattr(mod, name) for mod, name in flags]
    try:
        for mod, name in flags:
            setattr(mod, name, False)
        yield
    finally:
        for (mod, name), value in zip(flags, saved):
            setattr(mod, name, value)
