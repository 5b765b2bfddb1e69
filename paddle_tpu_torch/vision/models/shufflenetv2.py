"""ShuffleNetV2 (counterpart of ``paddle_tpu/vision/models/shufflenetv2.py``,
with JAX's layer names, so a JAX ``state_dict()`` loads; ``pretrained=True``
raises: no weights are fetched).

Channel split + shuffle instead of group conv: each unit splits channels,
convolves one half, concats, then interleaves groups so information mixes
across branches.
"""

from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, BatchNorm2D, ReLU, MaxPool2D,
                   AdaptiveAvgPool2D, Linear, Swish)
from ...ops.dispatch import apply, as_tensor
from ...tensor.manipulation import concat, flatten

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish", "channel_shuffle"]

_STAGE_OUT = {
    0.25: (24, 24, 48, 96, 512),
    0.33: (24, 32, 64, 128, 512),
    0.5: (24, 48, 96, 192, 1024),
    1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024),
    2.0: (24, 244, 488, 976, 2048),
}
_REPEATS = (4, 8, 4)


def channel_shuffle(x, groups: int):
    """[N, C, H, W] -> interleave the C axis across ``groups``."""
    x = as_tensor(x)
    n, c, h, w = x.shape

    def fn(a):
        return (a.reshape(n, groups, c // groups, h, w)
                 .transpose(1, 2).reshape(n, c, h, w))

    return apply("channel_shuffle", fn, x)


def _act(name):
    return Swish() if name == "swish" else ReLU()


class _Unit(Layer):
    """Stride-1 unit: split -> right branch 1x1/dw3x3/1x1 -> concat+shuffle."""

    def __init__(self, ch, act):
        super().__init__()
        half = ch // 2
        self.half = half
        self.branch = Sequential(
            Conv2D(half, half, 1, bias_attr=False), BatchNorm2D(half), _act(act),
            Conv2D(half, half, 3, padding=1, groups=half, bias_attr=False),
            BatchNorm2D(half),
            Conv2D(half, half, 1, bias_attr=False), BatchNorm2D(half), _act(act))

    def forward(self, x):
        left = x[:, :self.half]
        right = x[:, self.half:]
        out = concat([left, self.branch(right)], axis=1)
        return channel_shuffle(out, 2)


class _DownUnit(Layer):
    """Stride-2 unit: both branches convolve, channels double."""

    def __init__(self, inp, oup, act):
        super().__init__()
        half = oup // 2
        self.left = Sequential(
            Conv2D(inp, inp, 3, stride=2, padding=1, groups=inp,
                   bias_attr=False),
            BatchNorm2D(inp),
            Conv2D(inp, half, 1, bias_attr=False), BatchNorm2D(half), _act(act))
        self.right = Sequential(
            Conv2D(inp, half, 1, bias_attr=False), BatchNorm2D(half), _act(act),
            Conv2D(half, half, 3, stride=2, padding=1, groups=half,
                   bias_attr=False),
            BatchNorm2D(half),
            Conv2D(half, half, 1, bias_attr=False), BatchNorm2D(half), _act(act))

    def forward(self, x):
        out = concat([self.left(x), self.right(x)], axis=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(Layer):
    def __init__(self, scale: float = 1.0, act: str = "relu",
                 num_classes: int = 1000, with_pool: bool = True):
        super().__init__()
        if scale not in _STAGE_OUT:
            raise ValueError(f"scale must be one of {sorted(_STAGE_OUT)}")
        c0, c1, c2, c3, c4 = _STAGE_OUT[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            Conv2D(3, c0, 3, stride=2, padding=1, bias_attr=False),
            BatchNorm2D(c0), _act(act), MaxPool2D(3, stride=2, padding=1))
        stages = []
        inp = c0
        for oup, rep in zip((c1, c2, c3), _REPEATS):
            stages.append(_DownUnit(inp, oup, act))
            stages.extend(_Unit(oup, act) for _ in range(rep - 1))
            inp = oup
        self.stages = Sequential(*stages)
        self.head = Sequential(
            Conv2D(inp, c4, 1, bias_attr=False), BatchNorm2D(c4), _act(act))
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(c4, num_classes)

    def forward(self, x):
        x = self.head(self.stages(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def _make(scale, act, pretrained, **kw):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled; load a state_dict instead")
    return ShuffleNetV2(scale=scale, act=act, **kw)


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return _make(0.25, "relu", pretrained, **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return _make(0.33, "relu", pretrained, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return _make(0.5, "relu", pretrained, **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return _make(1.0, "relu", pretrained, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return _make(1.5, "relu", pretrained, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return _make(2.0, "relu", pretrained, **kw)


def shufflenet_v2_swish(pretrained=False, **kw):
    return _make(1.0, "swish", pretrained, **kw)
