"""``ReLU``, ``Silu``, ``GELU`` and ``Tanh`` (counterpart of
``paddle_tpu/nn/layer/activation.py``)."""

from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["ReLU", "Silu", "GELU", "Tanh"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class Silu(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.silu(x)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class Tanh(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)
