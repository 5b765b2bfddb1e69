"""AlexNet (counterpart of ``paddle_tpu/vision/models/alexnet.py``, with
JAX's layer names, so a JAX ``state_dict()`` loads; ``pretrained=True``
raises: no weights are fetched)."""

from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, MaxPool2D, ReLU, Linear,
                   Dropout, AdaptiveAvgPool2D)
from ...tensor.manipulation import flatten

__all__ = ["AlexNet", "alexnet"]


class AlexNet(Layer):
    """The 2012 ImageNet winner: 5 conv + 3 fc, ReLU + dropout."""

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(64, 192, 5, padding=2), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(192, 384, 3, padding=1), ReLU(),
            Conv2D(384, 256, 3, padding=1), ReLU(),
            Conv2D(256, 256, 3, padding=1), ReLU(),
            MaxPool2D(3, stride=2))
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.5), Linear(256 * 6 * 6, 4096), ReLU(),
                Dropout(0.5), Linear(4096, 4096), ReLU(),
                Linear(4096, num_classes))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def alexnet(pretrained: bool = False, **kwargs) -> AlexNet:
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled; load a state_dict instead")
    return AlexNet(**kwargs)
