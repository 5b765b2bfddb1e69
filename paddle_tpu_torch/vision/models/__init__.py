"""paddle.vision.models: ``LeNet`` and the ResNet family.  JAX's other nine
model files (VGG, MobileNet v1 / v2 / v3, AlexNet, SqueezeNet, DenseNet,
GoogLeNet, InceptionV3, ShuffleNetV2) are not ported yet (ROADMAP.md queue
1 item 10)."""

from .lenet import LeNet  # noqa: F401
from .resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnext50_32x4d, resnext101_32x8d,
    wide_resnet50_2, wide_resnet101_2)

__all__ = ["LeNet", "ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext101_32x8d", "wide_resnet50_2",
           "wide_resnet101_2"]
