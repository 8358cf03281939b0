"""MobileNetV3-Small — the paper's own lightweight CNN (~2.5M params).

Inverted residual blocks + squeeze-and-excitation; paper §IV-B.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mobilenet-v3-small",
    family="cnn",
    source="MobileNetV3 [Howard et al. 2019]; paper §IV-B",
    cnn_variant="mobilenet_v3_small",
    image_size=32,
    image_channels=3,
    num_classes=10,
)
