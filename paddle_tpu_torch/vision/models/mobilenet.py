"""MobileNetV1 / V2 (counterpart of ``paddle_tpu/vision/models/mobilenet.py``,
with JAX's layer names, so a JAX ``state_dict()`` loads; ``pretrained=True``
raises: no weights are fetched)."""

from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, BatchNorm2D, ReLU, ReLU6,
                   AdaptiveAvgPool2D, Linear, Dropout)

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


def _conv_bn(inp, oup, stride, relu6=False):
    return Sequential(
        Conv2D(inp, oup, 3, stride=stride, padding=1, bias_attr=False),
        BatchNorm2D(oup),
        ReLU6() if relu6 else ReLU())


def _conv_dw(inp, oup, stride):
    return Sequential(
        Conv2D(inp, inp, 3, stride=stride, padding=1, groups=inp,
               bias_attr=False),
        BatchNorm2D(inp), ReLU(),
        Conv2D(inp, oup, 1, bias_attr=False),
        BatchNorm2D(oup), ReLU())


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = lambda c: max(int(c * scale), 8)
        self.features = Sequential(
            _conv_bn(3, s(32), 2),
            _conv_dw(s(32), s(64), 1),
            _conv_dw(s(64), s(128), 2),
            _conv_dw(s(128), s(128), 1),
            _conv_dw(s(128), s(256), 2),
            _conv_dw(s(256), s(256), 1),
            _conv_dw(s(256), s(512), 2),
            *[_conv_dw(s(512), s(512), 1) for _ in range(5)],
            _conv_dw(s(512), s(1024), 2),
            _conv_dw(s(1024), s(1024), 1))
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(s(1024), num_classes)
        self._out = s(1024)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            from ...tensor.manipulation import reshape
            x = reshape(x, [x.shape[0], -1])
            x = self.fc(x)
        return x


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers += [Conv2D(inp, hidden, 1, bias_attr=False),
                       BatchNorm2D(hidden), ReLU6()]
        layers += [
            Conv2D(hidden, hidden, 3, stride=stride, padding=1,
                   groups=hidden, bias_attr=False),
            BatchNorm2D(hidden), ReLU6(),
            Conv2D(hidden, oup, 1, bias_attr=False), BatchNorm2D(oup)]
        self.conv = Sequential(*layers)

    def forward(self, x):
        if self.use_res:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        inp = max(int(32 * scale), 8)
        last = max(int(1280 * scale), 1280) if scale > 1.0 else 1280
        features = [_conv_bn(3, inp, 2, relu6=True)]
        for t, c, n, s in cfg:
            out = max(int(c * scale), 8)
            for i in range(n):
                features.append(InvertedResidual(
                    inp, out, s if i == 0 else 1, t))
                inp = out
        features += [Conv2D(inp, last, 1, bias_attr=False),
                     BatchNorm2D(last), ReLU6()]
        self.features = Sequential(*features)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = Sequential(Dropout(0.2),
                                         Linear(last, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            from ...tensor.manipulation import reshape
            x = reshape(x, [x.shape[0], -1])
            x = self.classifier(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights unavailable (zero egress)")
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights unavailable (zero egress)")
    return MobileNetV2(scale=scale, **kwargs)
