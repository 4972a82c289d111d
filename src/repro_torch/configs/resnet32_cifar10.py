"""ResNet-32 / CIFAR-10 — the paper's own experimental model (Table II).

1.9M params, 32 layers (6n+2, n=5), batch 128, Momentum optimizer,
64K training steps, top-1 92.49% reference accuracy.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="resnet32-cifar10",
        family="resnet",
        resnet_n=5,                # ResNet-(6*5+2) = ResNet-32
        image_size=32,
        num_classes=10,
    )


def reduced() -> ModelConfig:
    return full().replace(resnet_n=1, image_size=16)  # ResNet-8 @ 16px


register("resnet32-cifar10", full, reduced)
