"""Inception v3 (counterpart of ``paddle_tpu/vision/models/inceptionv3.py``,
with JAX's layer names, so a JAX ``state_dict()`` loads; ``pretrained=True``
raises: no weights are fetched).

Factorised convolutions: 5x5 -> two 3x3 (block A), nxn -> 1xn + nx1
(block C), and expanded filter banks (block E); 299x299 input.
"""

from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, BatchNorm2D, ReLU, MaxPool2D,
                   AvgPool2D, AdaptiveAvgPool2D, Linear, Dropout)
from ...tensor.manipulation import concat, flatten

__all__ = ["InceptionV3", "inception_v3"]


def _conv_bn(inp, oup, k, stride=1, padding=0):
    return Sequential(
        Conv2D(inp, oup, k, stride=stride, padding=padding, bias_attr=False),
        BatchNorm2D(oup), ReLU())


class _BlockA(Layer):
    def __init__(self, inp, pool_features):
        super().__init__()
        self.b1 = _conv_bn(inp, 64, 1)
        self.b2 = Sequential(_conv_bn(inp, 48, 1),
                             _conv_bn(48, 64, 5, padding=2))
        self.b3 = Sequential(_conv_bn(inp, 64, 1),
                             _conv_bn(64, 96, 3, padding=1),
                             _conv_bn(96, 96, 3, padding=1))
        self.b4 = Sequential(AvgPool2D(3, stride=1, padding=1, exclusive=False),
                             _conv_bn(inp, pool_features, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)], axis=1)


class _BlockB(Layer):
    """Grid reduction 35x35 -> 17x17."""

    def __init__(self, inp):
        super().__init__()
        self.b1 = _conv_bn(inp, 384, 3, stride=2)
        self.b2 = Sequential(_conv_bn(inp, 64, 1),
                             _conv_bn(64, 96, 3, padding=1),
                             _conv_bn(96, 96, 3, stride=2))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b1(x), self.b2(x), self.pool(x)], axis=1)


class _BlockC(Layer):
    """17x17 tower with 1x7/7x1 factorised convs."""

    def __init__(self, inp, c7):
        super().__init__()
        self.b1 = _conv_bn(inp, 192, 1)
        self.b2 = Sequential(
            _conv_bn(inp, c7, 1),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3)),
            _conv_bn(c7, 192, (7, 1), padding=(3, 0)))
        self.b3 = Sequential(
            _conv_bn(inp, c7, 1),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0)),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3)),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0)),
            _conv_bn(c7, 192, (1, 7), padding=(0, 3)))
        self.b4 = Sequential(AvgPool2D(3, stride=1, padding=1, exclusive=False),
                             _conv_bn(inp, 192, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)], axis=1)


class _BlockD(Layer):
    """Grid reduction 17x17 -> 8x8."""

    def __init__(self, inp):
        super().__init__()
        self.b1 = Sequential(_conv_bn(inp, 192, 1),
                             _conv_bn(192, 320, 3, stride=2))
        self.b2 = Sequential(
            _conv_bn(inp, 192, 1),
            _conv_bn(192, 192, (1, 7), padding=(0, 3)),
            _conv_bn(192, 192, (7, 1), padding=(3, 0)),
            _conv_bn(192, 192, 3, stride=2))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b1(x), self.b2(x), self.pool(x)], axis=1)


class _BlockE(Layer):
    """8x8 tower with split 1x3/3x1 branches."""

    def __init__(self, inp):
        super().__init__()
        self.b1 = _conv_bn(inp, 320, 1)
        self.b2_stem = _conv_bn(inp, 384, 1)
        self.b2_a = _conv_bn(384, 384, (1, 3), padding=(0, 1))
        self.b2_b = _conv_bn(384, 384, (3, 1), padding=(1, 0))
        self.b3_stem = Sequential(_conv_bn(inp, 448, 1),
                                  _conv_bn(448, 384, 3, padding=1))
        self.b3_a = _conv_bn(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _conv_bn(384, 384, (3, 1), padding=(1, 0))
        self.b4 = Sequential(AvgPool2D(3, stride=1, padding=1, exclusive=False),
                             _conv_bn(inp, 192, 1))

    def forward(self, x):
        s2 = self.b2_stem(x)
        s3 = self.b3_stem(x)
        return concat([
            self.b1(x),
            concat([self.b2_a(s2), self.b2_b(s2)], axis=1),
            concat([self.b3_a(s3), self.b3_b(s3)], axis=1),
            self.b4(x)], axis=1)


class InceptionV3(Layer):
    def __init__(self, num_classes: int = 1000, with_pool: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            _conv_bn(3, 32, 3, stride=2), _conv_bn(32, 32, 3),
            _conv_bn(32, 64, 3, padding=1), MaxPool2D(3, stride=2),
            _conv_bn(64, 80, 1), _conv_bn(80, 192, 3),
            MaxPool2D(3, stride=2))
        self.blocks = Sequential(
            _BlockA(192, 32), _BlockA(256, 64), _BlockA(288, 64),
            _BlockB(288),
            _BlockC(768, 128), _BlockC(768, 160), _BlockC(768, 160),
            _BlockC(768, 192),
            _BlockD(768),
            _BlockE(1280), _BlockE(2048))
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = Dropout(0.5)
            self.fc = Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(flatten(x, 1)))
        return x


def inception_v3(pretrained: bool = False, **kwargs) -> InceptionV3:
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled; load a state_dict instead")
    return InceptionV3(**kwargs)
