"""GoogLeNet / Inception v1 (counterpart of
``paddle_tpu/vision/models/googlenet.py``, with JAX's layer names, so a JAX
``state_dict()`` loads; ``pretrained=True`` raises: no weights are fetched).

Paddle's structure: plain convs (no BN), one ReLU after
each inception concat, floor-mode 3x3/s2 pools, aux heads tapping the
ince4a (512ch) and ince4d (528ch) outputs through AvgPool2D(5,3) + 1x1
conv(128) + Linear(1152, 1024). Returns (main, aux1, aux2).
"""

from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, MaxPool2D, AvgPool2D, ReLU,
                   AdaptiveAvgPool2D, Linear, Dropout)
from ...nn import functional as F
from ...tensor.manipulation import concat, flatten

__all__ = ["GoogLeNet", "googlenet"]


def _conv(inp, oup, k, stride=1):
    return Conv2D(inp, oup, k, stride=stride, padding=(k - 1) // 2,
                  bias_attr=False)


class _Inception(Layer):
    """Four parallel towers: 1x1 | 1x1-3x3 | 1x1-5x5 | pool-1x1; a single
    ReLU on the concat (Paddle's Inception.forward)."""

    def __init__(self, inp, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _conv(inp, c1, 1)
        self.b2 = Sequential(_conv(inp, c3r, 1), _conv(c3r, c3, 3))
        self.b3 = Sequential(_conv(inp, c5r, 1), _conv(c5r, c5, 5))
        self.b4 = Sequential(MaxPool2D(3, stride=1, padding=1),
                             _conv(inp, proj, 1))
        self.relu = ReLU()

    def forward(self, x):
        return self.relu(concat(
            [self.b1(x), self.b2(x), self.b3(x), self.b4(x)], axis=1))


class GoogLeNet(Layer):
    def __init__(self, num_classes: int = 1000, with_pool: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem_conv = _conv(3, 64, 7, stride=2)
        self.pool = MaxPool2D(3, stride=2)
        self.conv1 = _conv(64, 64, 1)
        self.conv2 = _conv(64, 192, 3)
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.pool5 = AdaptiveAvgPool2D((1, 1))
            self.pool_aux1 = AvgPool2D(5, stride=3)
            self.pool_aux2 = AvgPool2D(5, stride=3)
        if num_classes > 0:
            self.dropout = Dropout(0.4)
            self.fc = Linear(1024, num_classes)
            self.conv_aux1 = _conv(512, 128, 1)
            self.fc_aux1 = Linear(1152, 1024)
            self.drop_aux1 = Dropout(0.7)
            self.out_aux1 = Linear(1024, num_classes)
            self.conv_aux2 = _conv(528, 128, 1)
            self.fc_aux2 = Linear(1152, 1024)
            self.drop_aux2 = Dropout(0.7)
            self.out_aux2 = Linear(1024, num_classes)

    def forward(self, x):
        x = self.pool(self.stem_conv(x))
        x = self.pool(self.conv2(self.conv1(x)))
        x = self.pool(self.i3b(self.i3a(x)))
        a4 = self.i4a(x)
        x = self.i4c(self.i4b(a4))
        d4 = self.i4d(x)
        x = self.pool(self.i4e(d4))
        out = self.i5b(self.i5a(x))
        out1, out2 = a4, d4
        if self.with_pool:
            out = self.pool5(out)
            out1 = self.pool_aux1(out1)
            out2 = self.pool_aux2(out2)
        if self.num_classes > 0:
            out = self.fc(flatten(self.dropout(out), 1))
            out1 = self.fc_aux1(flatten(self.conv_aux1(out1), 1))
            out1 = self.out_aux1(self.drop_aux1(F.relu(out1)))
            # Paddle applies no relu on the second aux fc
            out2 = self.fc_aux2(flatten(self.conv_aux2(out2), 1))
            out2 = self.out_aux2(self.drop_aux2(out2))
        return out, out1, out2


def googlenet(pretrained: bool = False, **kwargs) -> GoogLeNet:
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled; load a state_dict instead")
    return GoogLeNet(**kwargs)
