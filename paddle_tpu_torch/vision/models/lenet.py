"""LeNet (counterpart of ``paddle_tpu/vision/models/lenet.py``): two
convolutions with ReLU and 2 x 2 max pools, then three linear layers, for
``[N, 1, 28, 28]`` images."""

from __future__ import annotations

from ...nn import Conv2D, Layer, Linear, MaxPool2D, ReLU, Sequential
from ...tensor.manipulation import flatten

__all__ = ["LeNet"]


class LeNet(Layer):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1),
            ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0),
            ReLU(),
            MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120),
                Linear(120, 84),
                Linear(84, num_classes),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x
