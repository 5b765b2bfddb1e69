"""DenseNet (counterpart of ``paddle_tpu/vision/models/densenet.py``, with
JAX's layer names, so a JAX ``state_dict()`` loads; ``pretrained=True``
raises: no weights are fetched).

Dense connectivity: each layer receives the channel-concat of every
previous feature map in its block; transition layers halve channels and
spatial dims.
"""

from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, BatchNorm2D, ReLU,
                   MaxPool2D, AvgPool2D, AdaptiveAvgPool2D, Linear, Dropout)
from ...tensor.manipulation import concat, flatten

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_ARCHS = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class _DenseLayer(Layer):
    """BN-ReLU-Conv1x1(bottleneck) -> BN-ReLU-Conv3x3, output concatenated."""

    def __init__(self, inp, growth, bn_size, dropout):
        super().__init__()
        self.fn = Sequential(
            BatchNorm2D(inp), ReLU(),
            Conv2D(inp, bn_size * growth, 1, bias_attr=False),
            BatchNorm2D(bn_size * growth), ReLU(),
            Conv2D(bn_size * growth, growth, 3, padding=1, bias_attr=False))
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        y = self.fn(x)
        if self.dropout is not None:
            y = self.dropout(y)
        return concat([x, y], axis=1)


class _Transition(Layer):
    def __init__(self, inp, oup):
        super().__init__()
        self.fn = Sequential(
            BatchNorm2D(inp), ReLU(), Conv2D(inp, oup, 1, bias_attr=False),
            AvgPool2D(2, stride=2))

    def forward(self, x):
        return self.fn(x)


class DenseNet(Layer):
    def __init__(self, layers: int = 121, bn_size: int = 4,
                 dropout: float = 0.0, num_classes: int = 1000,
                 with_pool: bool = True):
        super().__init__()
        if layers not in _ARCHS:
            raise ValueError(f"layers must be one of {sorted(_ARCHS)}")
        num_init, growth, block_cfg = _ARCHS[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            Conv2D(3, num_init, 7, stride=2, padding=3, bias_attr=False),
            BatchNorm2D(num_init), ReLU(), MaxPool2D(3, stride=2, padding=1))
        blocks = []
        ch = num_init
        for bi, n in enumerate(block_cfg):
            for _ in range(n):
                blocks.append(_DenseLayer(ch, growth, bn_size, dropout))
                ch += growth
            if bi != len(block_cfg) - 1:
                blocks.append(_Transition(ch, ch // 2))
                ch //= 2
        self.blocks = Sequential(*blocks)
        self.final = Sequential(BatchNorm2D(ch), ReLU())
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(ch, num_classes)

    def forward(self, x):
        x = self.final(self.blocks(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def _make(layers, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled; load a state_dict instead")
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kw):
    return _make(121, pretrained, **kw)


def densenet161(pretrained=False, **kw):
    return _make(161, pretrained, **kw)


def densenet169(pretrained=False, **kw):
    return _make(169, pretrained, **kw)


def densenet201(pretrained=False, **kw):
    return _make(201, pretrained, **kw)


def densenet264(pretrained=False, **kw):
    return _make(264, pretrained, **kw)
