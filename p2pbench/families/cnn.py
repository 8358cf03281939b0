"""The paper's CNNs: CIFAR-shaped images (seeded normal pixels, NCHW f32)
and labels drawn uniformly from the classes; the program's loss is
``core.simulate.cnn_loss`` over the configuration's model; work is counted
in images. The CNN runs in full float32 (the port's ``f32_numerics``: no
TF32), so its peak is the float32 one."""
from __future__ import annotations

import torch

from p2pbench import costs
from p2pbench.reference import vgg as reference

UNIT = "images"
PEAK_FLOPS = costs.PEAK_FLOPS_FP32


def make_batch(config: dict, cell: dict, generator: torch.Generator, device) -> dict:
    m, rows = config["model"], units(cell)
    images = torch.randn((rows, m["image_channels"], m["image_size"], m["image_size"]),
                         generator=generator, device=device)
    labels = torch.randint(0, m["num_classes"], (rows,), generator=generator, device=device)
    return {"images": images, "labels": labels}


def units(cell: dict) -> int:
    return cell["peers"] * cell["rows_per_peer"]


def train_flops(config: dict, cell: dict) -> float:
    return costs.cnn_train_flops(reference.forward_flops(config), units(cell))


def program_loss(config: dict):
    """The program's per-peer loss over a skeleton of its model on the meta
    device (the step supplies the params)."""
    from repro_torch import models
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.simulate import cnn_loss

    model = models.init_model(ModelConfig(**config["model"]), generator=None, device="meta")
    return lambda params, batch: cnn_loss(model, params, batch["images"], batch["labels"])


def reference_loss(config: dict):
    return lambda params, batch, precision: reference.loss(params, batch, config, precision)
