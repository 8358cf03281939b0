"""VGG-11 (arXiv:1409.1556, configuration A) as the P2P paper trains it on
CIFAR-shaped images (§IV-B): 3x3 convolutions with stride 1 and padding 1,
each followed by ReLU, 2x2 max pools, then the linear layers with ReLU
between them, and the mean cross-entropy over the batch. No batch norm,
no dropout.

Parameters are named and laid out as the benchmark hands them to both
sides: ``convs.<i>.w`` (out, in, 3, 3) and ``convs.<i>.b``, then ``fc<j>.w``
(out, in) and ``fc<j>.b``, initialised as torchvision initialises its VGG:
convolutions He-normal over their fan-out, linear weights normal with std
0.01, zero biases. Below 64 pixels
the features are pooled to 1 x 1; above, to 7 x 7, flattened
channel-last (the order the first linear layer's rows follow).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from p2pbench.reference.precision import operand


def param_spec(config: dict) -> List[Tuple[str, tuple, tuple]]:
    """``[(name, shape, init)]`` in order; init is ``("normal", std)`` or
    ``("const", value)``."""
    model = config["model"]
    spec, cin, i = [], model["image_channels"], 0
    for item in config["plan"]:
        if item == "M":
            continue
        spec.append((f"convs.{i}.w", (item, cin, 3, 3), ("normal", math.sqrt(2.0 / (9 * item)))))
        spec.append((f"convs.{i}.b", (item,), ("const", 0.0)))
        cin, i = item, i + 1
    pool = 7 if model["image_size"] >= 64 else 1
    widths = [cin * pool * pool, *config["fc"], model["num_classes"]]
    for j, (din, dout) in enumerate(zip(widths, widths[1:]), start=1):
        spec.append((f"fc{j}.w", (dout, din), ("normal", 0.01)))
        spec.append((f"fc{j}.b", (dout,), ("const", 0.0)))
    return spec


def forward_flops(config: dict) -> int:
    """Forward FLOPs of one image, 2 a multiply-add, convolutions and linear
    layers only."""
    model = config["model"]
    hw, cin, flops = model["image_size"], model["image_channels"], 0
    for item in config["plan"]:
        if item == "M":
            hw //= 2
        else:
            flops += 2 * hw * hw * cin * item * 9
            cin = item
    pool = 7 if model["image_size"] >= 64 else 1
    widths = [cin * pool * pool, *config["fc"], model["num_classes"]]
    return flops + sum(2 * a * b for a, b in zip(widths, widths[1:]))


def loss(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], config: dict,
         precision: str = "f32") -> torch.Tensor:
    """Mean cross-entropy of ``batch["images"]`` (n, C, H, W) against
    ``batch["labels"]`` (n,)."""
    q = lambda t: operand(t, precision)
    x, i = batch["images"], 0
    for item in config["plan"]:
        if item == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        x = F.relu(F.conv2d(q(x), q(params[f"convs.{i}.w"]), params[f"convs.{i}.b"], padding=1))
        i += 1
    pool = 7 if config["model"]["image_size"] >= 64 else 1
    if x.shape[2] != pool:
        win = x.shape[2] // pool
        x = F.avg_pool2d(x, win, win)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    layers = len(config["fc"]) + 1
    for j in range(1, layers + 1):
        x = F.linear(q(x), q(params[f"fc{j}.w"]), params[f"fc{j}.b"])
        if j < layers:
            x = F.relu(x)
    return F.cross_entropy(x, batch["labels"])
