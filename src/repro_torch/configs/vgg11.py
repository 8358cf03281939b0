"""VGG-11 — the paper's own heavyweight CNN [arXiv:1409.1556].

~132.9M parameters at 224x224. The paper trains it on MNIST/CIFAR on
t2.large instances; we default to 32x32 inputs (CIFAR-native) for the CPU
benchmark harness, with ``image_size=224`` available.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="vgg11",
    family="cnn",
    source="VGG [arXiv:1409.1556]; paper §IV-B",
    cnn_variant="vgg11",
    image_size=32,
    image_channels=3,
    num_classes=10,
)
