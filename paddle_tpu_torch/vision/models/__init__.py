"""paddle.vision.models: LeNet and JAX's ten model families (counterpart
of ``paddle_tpu/vision/models/__init__.py``, with its ``__all__``; the
ResNet blocks are importable here as well)."""

from .lenet import LeNet  # noqa: F401
from .resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
    resnext50_32x4d, resnext101_32x8d, wide_resnet50_2, wide_resnet101_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .mobilenet import (  # noqa: F401
    MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2)
from .mobilenetv3 import (  # noqa: F401
    MobileNetV3Small, MobileNetV3Large, mobilenet_v3_small,
    mobilenet_v3_large)
from .alexnet import AlexNet, alexnet  # noqa: F401
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .densenet import (  # noqa: F401
    DenseNet, densenet121, densenet161, densenet169, densenet201,
    densenet264)
from .googlenet import GoogLeNet, googlenet  # noqa: F401
from .inceptionv3 import InceptionV3, inception_v3  # noqa: F401
from .shufflenetv2 import (  # noqa: F401
    ShuffleNetV2, shufflenet_v2_x0_25, shufflenet_v2_x0_33,
    shufflenet_v2_x0_5, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0, shufflenet_v2_swish)

__all__ = [
    "LeNet", "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
    "resnet152", "resnext50_32x4d", "resnext101_32x8d", "wide_resnet50_2",
    "wide_resnet101_2", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
    "MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2",
    "MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
    "mobilenet_v3_large", "AlexNet", "alexnet", "SqueezeNet",
    "squeezenet1_0", "squeezenet1_1", "DenseNet", "densenet121",
    "densenet161", "densenet169", "densenet201", "densenet264",
    "GoogLeNet", "googlenet", "InceptionV3", "inception_v3",
    "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "shufflenet_v2_swish",
]
