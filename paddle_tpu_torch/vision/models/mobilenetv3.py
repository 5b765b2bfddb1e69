"""MobileNetV3 Small / Large (counterpart of
``paddle_tpu/vision/models/mobilenetv3.py``, with JAX's layer names, so a
JAX ``state_dict()`` loads; ``pretrained=True`` raises: no weights are
fetched).

Inverted residuals with squeeze-excitation and hard-swish, searched stage
configs from the paper.
"""

from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, BatchNorm2D, ReLU, Hardswish,
                   Hardsigmoid, AdaptiveAvgPool2D, Linear, Dropout)
from ...tensor.manipulation import flatten

__all__ = ["MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large"]


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _SE(Layer):
    def __init__(self, ch, squeeze):
        super().__init__()
        self.pool = AdaptiveAvgPool2D((1, 1))
        self.fn = Sequential(
            Conv2D(ch, squeeze, 1), ReLU(),
            Conv2D(squeeze, ch, 1), Hardsigmoid())

    def forward(self, x):
        return x * self.fn(self.pool(x))


class _InvertedResidual(Layer):
    def __init__(self, inp, exp, oup, k, stride, use_se, use_hs):
        super().__init__()
        self.residual = stride == 1 and inp == oup
        act = Hardswish if use_hs else ReLU
        layers = []
        if exp != inp:
            layers += [Conv2D(inp, exp, 1, bias_attr=False),
                       BatchNorm2D(exp), act()]
        layers += [Conv2D(exp, exp, k, stride=stride, padding=k // 2,
                          groups=exp, bias_attr=False),
                   BatchNorm2D(exp)]
        if use_se:
            layers.append(_SE(exp, _make_divisible(exp // 4)))
        layers += [act(),
                   Conv2D(exp, oup, 1, bias_attr=False), BatchNorm2D(oup)]
        self.fn = Sequential(*layers)

    def forward(self, x):
        y = self.fn(x)
        return x + y if self.residual else y


# (kernel, expansion, out, use_se, use_hs, stride)
_LARGE = [
    (3, 16, 16, False, False, 1), (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1), (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1), (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2), (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1), (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1), (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2), (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]
_SMALL = [
    (3, 16, 16, True, False, 2), (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1), (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1), (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1), (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2), (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
]


class _MobileNetV3(Layer):
    def __init__(self, cfg, last_ch_base, scale, num_classes, with_pool):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = lambda c: _make_divisible(c * scale)
        self.stem = Sequential(
            Conv2D(3, s(16), 3, stride=2, padding=1, bias_attr=False),
            BatchNorm2D(s(16)), Hardswish())
        blocks = []
        inp = s(16)
        for k, exp, oup, se, hs, stride in cfg:
            blocks.append(_InvertedResidual(inp, s(exp), s(oup), k, stride,
                                            se, hs))
            inp = s(oup)
        self.blocks = Sequential(*blocks)
        # Paddle's head: lastconv_out = 6x the scaled trunk output,
        # penultimate width = _make_divisible(base * scale)
        lastconv_out = inp * 6
        last_ch = _make_divisible(last_ch_base * scale)
        self.head_conv = Sequential(
            Conv2D(inp, lastconv_out, 1, bias_attr=False),
            BatchNorm2D(lastconv_out), Hardswish())
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(lastconv_out, last_ch), Hardswish(), Dropout(0.2),
                Linear(last_ch, num_classes))

    def forward(self, x):
        x = self.head_conv(self.blocks(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_SMALL, 1024, scale, num_classes, with_pool)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_LARGE, 1280, scale, num_classes, with_pool)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kw):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled; load a state_dict instead")
    return MobileNetV3Small(scale=scale, **kw)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kw):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled; load a state_dict instead")
    return MobileNetV3Large(scale=scale, **kw)
