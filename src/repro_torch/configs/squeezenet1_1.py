"""SqueezeNet 1.1 — the paper's own smallest CNN (~1.2M params, <5MB).

Fire modules (squeeze 1x1 -> expand 1x1/3x3); paper §IV-B.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="squeezenet1.1",
    family="cnn",
    source="SqueezeNet [arXiv:1602.07360]; paper §IV-B",
    cnn_variant="squeezenet1_1",
    image_size=32,
    image_channels=3,
    num_classes=10,
)
