"""The paper's own CNNs — VGG-11, MobileNetV3-Small, SqueezeNet 1.1 — as
``nn.Module``s on NCHW tensors.

They compute what the reference's ``repro/models/cnn.py`` computes, and
their parameters carry the reference's names: a module attribute per dict
key (``blocks``, ``dw``, ``stem_bn``, ...) and ``w``/``b`` or
``scale``/``bias`` leaves, so ``blocks.0.dw.w`` here is ``blocks/0/dw/w``
there. Weights are in PyTorch's layout: convolutions OIHW (depthwise
``(C, 1, k, k)``), linear layers ``(out, in)``; ``repro_torch.convert``
maps them to the reference's HWIO and ``(in, out)``.

Parity with the reference:

* ``padding="SAME"`` is XLA's: ``low = total // 2``, ``high = total - low``,
  asymmetric at stride 2, applied with an explicit ``F.pad``.
* BatchNorm normalizes with the batch's own moments (biased variance) and
  keeps no running statistics.
* Pools use VALID windows.

:func:`f32_numerics` is the scope in which the port runs the CNNs'
forward and backward and the f32 mixing products: cuDNN without TF32, with
deterministic algorithms and no autotuning, and f32 matrix products at full
precision, whatever the caller's global flags, so that a seeded run repeats
itself bit for bit on the card.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, List

import torch
import torch.nn.functional as F
from torch import nn


_F32_FLAGS = (  # (backend module, flag, value inside f32_numerics)
    (torch.backends.cudnn, "allow_tf32", False),
    (torch.backends.cudnn, "deterministic", True),
    (torch.backends.cudnn, "benchmark", False),
    (torch.backends.cuda.matmul, "allow_tf32", False),
)


@contextlib.contextmanager
def f32_numerics() -> Iterator[None]:
    """For its duration: cuDNN convolutions in full f32 (no TF32), on
    deterministic algorithms, without autotuning; f32 matrix products at
    full precision. The caller's settings come back on exit, also when the
    body raises. The flags are process-wide, as PyTorch's are."""
    saved = [getattr(mod, name) for mod, name, _ in _F32_FLAGS]
    try:
        for mod, name, value in _F32_FLAGS:
            setattr(mod, name, value)
        yield
    finally:
        for (mod, name, _), value in zip(_F32_FLAGS, saved):
            setattr(mod, name, value)


def _randn(shape, std: float, generator: torch.Generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device) * std


class Conv(nn.Module):
    """A convolution's ``w`` (OIHW) and ``b``; He-normal init as the reference."""

    def __init__(self, kh, kw, cin, cout, *, generator, device):
        super().__init__()
        fan_in = kh * kw * cin
        self.w = nn.Parameter(
            _randn((cout, cin, kh, kw), math.sqrt(2.0 / fan_in), generator, device)
        )
        self.b = nn.Parameter(torch.zeros(cout, device=device))


class BatchNorm(nn.Module):
    def __init__(self, c, *, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))


class Linear(nn.Module):
    """A dense layer's ``w`` (out, in) and ``b``."""

    def __init__(self, din, dout, *, generator, device):
        super().__init__()
        self.w = nn.Parameter(_randn((dout, din), math.sqrt(2.0 / din), generator, device))
        self.b = nn.Parameter(torch.zeros(dout, device=device))


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p: Conv, x: torch.Tensor, stride: int = 1, groups: int = 1) -> torch.Tensor:
    kh, kw = p.w.shape[2], p.w.shape[3]
    top, bottom = _same_pads(x.shape[2], kh, stride)
    left, right = _same_pads(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, p.w, p.b, stride=stride, groups=groups)


def batchnorm(p: BatchNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), correction=0, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p.scale[:, None, None] + p.bias[:, None, None]


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    return F.max_pool2d(x, window, stride)


def avg_pool_to(x: torch.Tensor, out_hw: int) -> torch.Tensor:
    h = x.shape[2]
    if h == out_hw:
        return x
    win = max(h // out_hw, 1)
    return F.avg_pool2d(x, win, win)


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p.w, p.b)


# ---------------------------------------------------------------------------
# VGG-11
# ---------------------------------------------------------------------------

_VGG11_PLAN = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


class VGG11(nn.Module):
    def __init__(self, cfg, *, generator, device):
        super().__init__()
        self.cfg = cfg
        g = dict(generator=generator, device=device)
        cin = cfg.image_channels
        convs: List[Conv] = []
        for item in _VGG11_PLAN:
            if item == "M":
                continue
            convs.append(Conv(3, 3, cin, item, **g))
            cin = item
        self.convs = nn.ModuleList(convs)
        self.pool_hw = 7 if cfg.image_size >= 64 else 1
        flat = 512 * self.pool_hw * self.pool_hw
        self.fc1 = Linear(flat, 4096, **g)
        self.fc2 = Linear(4096, 4096, **g)
        self.fc3 = Linear(4096, cfg.num_classes, **g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ci = 0
        for item in _VGG11_PLAN:
            if item == "M":
                x = max_pool(x)
            else:
                x = F.relu(conv2d(self.convs[ci], x))
                ci += 1
        x = avg_pool_to(x, self.pool_hw)
        # flatten in the reference's NHWC order, which fc1's rows follow
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(linear(self.fc1, x))
        x = F.relu(linear(self.fc2, x))
        return linear(self.fc3, x)


# ---------------------------------------------------------------------------
# SqueezeNet 1.1
# ---------------------------------------------------------------------------

# (squeeze, expand1x1, expand3x3)
_FIRE_PLAN = [
    (16, 64, 64), (16, 64, 64),
    (32, 128, 128), (32, 128, 128),
    (48, 192, 192), (48, 192, 192), (64, 256, 256), (64, 256, 256),
]
_FIRE_POOL_AFTER = {1, 3}  # maxpool after these fire indices (v1.1)


class Fire(nn.Module):
    def __init__(self, cin, s, e1, e3, *, generator, device):
        super().__init__()
        g = dict(generator=generator, device=device)
        self.squeeze = Conv(1, 1, cin, s, **g)
        self.e1 = Conv(1, 1, s, e1, **g)
        self.e3 = Conv(3, 3, s, e3, **g)


class SqueezeNet(nn.Module):
    def __init__(self, cfg, *, generator, device):
        super().__init__()
        self.cfg = cfg
        g = dict(generator=generator, device=device)
        self.stem = Conv(3, 3, cfg.image_channels, 64, **g)
        cin = 64
        fires = []
        for (s, e1, e3) in _FIRE_PLAN:
            fires.append(Fire(cin, s, e1, e3, **g))
            cin = e1 + e3
        self.fires = nn.ModuleList(fires)
        self.head = Conv(1, 1, cin, cfg.num_classes, **g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        small = self.cfg.image_size < 64
        x = F.relu(conv2d(self.stem, x, stride=1 if small else 2))
        if not small:
            x = max_pool(x, 3, 2)
        for i, f in enumerate(self.fires):
            s = F.relu(conv2d(f.squeeze, x))
            x = torch.cat([F.relu(conv2d(f.e1, s)), F.relu(conv2d(f.e3, s))], dim=1)
            if i in _FIRE_POOL_AFTER:
                x = max_pool(x, 3, 2)
        x = F.relu(conv2d(self.head, x))
        return x.mean(dim=(2, 3))  # global average pool -> logits


# ---------------------------------------------------------------------------
# MobileNetV3-Small
# ---------------------------------------------------------------------------

# (kernel, exp, out, SE, activation, stride)
_MBV3_PLAN = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hswish", 2),
    (5, 240, 40, True, "hswish", 1),
    (5, 240, 40, True, "hswish", 1),
    (5, 120, 48, True, "hswish", 1),
    (5, 144, 48, True, "hswish", 1),
    (5, 288, 96, True, "hswish", 2),
    (5, 576, 96, True, "hswish", 1),
    (5, 576, 96, True, "hswish", 1),
]


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    return F.relu(x) if kind == "relu" else x * F.relu6(x + 3) / 6


class InvertedResidual(nn.Module):
    def __init__(self, cin, k, exp, out, se, *, generator, device):
        super().__init__()
        g = dict(generator=generator, device=device)
        self.expand = Conv(1, 1, cin, exp, **g)
        self.expand_bn = BatchNorm(exp, device=device)
        self.dw = Conv(k, k, 1, exp, **g)
        self.dw_bn = BatchNorm(exp, device=device)
        self.project = Conv(1, 1, exp, out, **g)
        self.project_bn = BatchNorm(out, device=device)
        self.se = se
        if se:
            sq = max(exp // 4, 8)
            self.se_fc1 = Conv(1, 1, exp, sq, **g)
            self.se_fc2 = Conv(1, 1, sq, exp, **g)


class MobileNetV3Small(nn.Module):
    def __init__(self, cfg, *, generator, device):
        super().__init__()
        self.cfg = cfg
        g = dict(generator=generator, device=device)
        self.stem = Conv(3, 3, cfg.image_channels, 16, **g)
        self.stem_bn = BatchNorm(16, device=device)
        cin = 16
        blocks = []
        for (k, exp, out, se, _act_kind, _stride) in _MBV3_PLAN:
            blocks.append(InvertedResidual(cin, k, exp, out, se, **g))
            cin = out
        self.blocks = nn.ModuleList(blocks)
        self.head_conv = Conv(1, 1, cin, 576, **g)
        self.head_bn = BatchNorm(576, device=device)
        self.fc1 = Linear(576, 1024, **g)
        self.fc2 = Linear(1024, cfg.num_classes, **g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        small = self.cfg.image_size < 64
        x = conv2d(self.stem, x, stride=1 if small else 2)
        x = _act(batchnorm(self.stem_bn, x), "hswish")
        for b, (k, exp, out, se, actk, stride) in zip(self.blocks, _MBV3_PLAN):
            if small and x.shape[2] <= 4:
                stride = 1  # don't collapse tiny feature maps below 4x4
            inp = x
            h = _act(batchnorm(b.expand_bn, conv2d(b.expand, x)), actk)
            h = conv2d(b.dw, h, stride=stride, groups=h.shape[1])
            h = _act(batchnorm(b.dw_bn, h), actk)
            if b.se:
                s = h.mean(dim=(2, 3), keepdim=True)
                s = F.relu(conv2d(b.se_fc1, s))
                s = torch.sigmoid(conv2d(b.se_fc2, s))
                h = h * s
            h = batchnorm(b.project_bn, conv2d(b.project, h))
            x = h + inp if (stride == 1 and inp.shape[1] == h.shape[1]) else h
        x = _act(batchnorm(self.head_bn, conv2d(self.head_conv, x)), "hswish")
        x = x.mean(dim=(2, 3))
        x = _act(linear(self.fc1, x), "hswish")
        return linear(self.fc2, x)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

CNN_ZOO = {
    "vgg11": VGG11,
    "squeezenet1_1": SqueezeNet,
    "mobilenet_v3_small": MobileNetV3Small,
}


def init_cnn(cfg, *, generator: torch.Generator, device) -> nn.Module:
    return CNN_ZOO[cfg.cnn_variant](cfg, generator=generator, device=device)
