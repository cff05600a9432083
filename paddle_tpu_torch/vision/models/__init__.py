"""The vision model zoo — the port of `paddle_tpu/vision/models`, as far
as it goes: `LeNet` (BASELINE.md config 1) and the ResNet family (config
2)."""
from .lenet import LeNet
from .resnet import (
    ResNet, resnet18, resnet34, resnet50, resnet101, resnet152, BasicBlock,
    BottleneckBlock, wide_resnet50_2, wide_resnet101_2, resnext50_32x4d,
    resnext50_64x4d, resnext101_32x4d, resnext101_64x4d, resnext152_32x4d,
    resnext152_64x4d,
)

__all__ = [
    "LeNet", "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
    "resnet152", "BasicBlock", "BottleneckBlock", "wide_resnet50_2",
    "wide_resnet101_2", "resnext50_32x4d", "resnext50_64x4d",
    "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
    "resnext152_64x4d",
]
