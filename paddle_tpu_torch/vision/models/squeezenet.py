"""SqueezeNet 1.0 / 1.1 (counterpart of
``paddle_tpu/vision/models/squeezenet.py``, with JAX's layer names, so a JAX
``state_dict()`` loads; ``pretrained=True`` raises: no weights are fetched).

Paddle's structure: biased convs, floor-mode 3x3/s2
pools, dropout -> 1x1 conv classifier -> ReLU -> global avg pool.
"""

from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, MaxPool2D, ReLU, Dropout,
                   AdaptiveAvgPool2D)
from ...tensor.manipulation import concat, flatten

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(Layer):
    """squeeze 1x1 -> expand (1x1 | 3x3) concat (Paddle's MakeFire)."""

    def __init__(self, inp, squeeze, e1, e3):
        super().__init__()
        self.squeeze = Sequential(Conv2D(inp, squeeze, 1), ReLU())
        self.expand1 = Sequential(Conv2D(squeeze, e1, 1), ReLU())
        self.expand3 = Sequential(Conv2D(squeeze, e3, 3, padding=1), ReLU())

    def forward(self, x):
        s = self.squeeze(x)
        return concat([self.expand1(s), self.expand3(s)], axis=1)


class SqueezeNet(Layer):
    def __init__(self, version: str = "1.0", num_classes: int = 1000,
                 with_pool: bool = True):
        super().__init__()
        if version not in ("1.0", "1.1"):
            raise ValueError(f"unsupported SqueezeNet version {version!r}")
        self.version = version
        self.num_classes = num_classes
        self.with_pool = with_pool
        pool = lambda: MaxPool2D(3, stride=2, padding=0)
        fires = [_Fire(96 if version == "1.0" else 64, 16, 64, 64),
                 _Fire(128, 16, 64, 64), _Fire(128, 32, 128, 128),
                 _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                 _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                 _Fire(512, 64, 256, 256)]
        if version == "1.0":
            # pools after fire3 and fire7
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2), ReLU(), pool(),
                fires[0], fires[1], fires[2], pool(),
                fires[3], fires[4], fires[5], fires[6], pool(),
                fires[7])
        else:
            # 1.1: 3x3 stem with padding, pools after fire2 and fire4
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2, padding=1), ReLU(), pool(),
                fires[0], fires[1], pool(),
                fires[2], fires[3], pool(),
                fires[4], fires[5], fires[6], fires[7])
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.5), Conv2D(512, num_classes, 1))
        if with_pool:
            self.relu_out = ReLU()
            self.pool_out = AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.pool_out(self.relu_out(x))
            x = flatten(x, 1)
        return x


def squeezenet1_0(pretrained: bool = False, **kwargs) -> SqueezeNet:
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled; load a state_dict instead")
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained: bool = False, **kwargs) -> SqueezeNet:
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled; load a state_dict instead")
    return SqueezeNet("1.1", **kwargs)
