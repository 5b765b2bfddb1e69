"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer/``):
``Constant``, ``Normal``, ``Uniform``, ``XavierUniform`` and
``XavierNormal``.  Each draws on the device it is asked for from the
framework's generator there (``framework/random.py``), in the asked type;
the values differ from ``jax.random``'s, their distribution does not."""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ...framework import dtype as dtypes
from ...framework import random as framework_random

__all__ = ["Initializer", "Constant", "Normal", "Uniform", "XavierNormal",
           "XavierUniform"]


def _fans(shape: Sequence[int]):
    shape = list(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]        # Paddle's linear weights: [in, out]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """``init(shape, dtype, device) -> torch.Tensor``."""

    def __call__(self, shape, dtype, device):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype, device):
        return torch.full(tuple(shape), self.value,
                          dtype=dtypes.to_torch_dtype(dtype), device=device)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device):
        out = torch.empty(tuple(shape), dtype=dtypes.to_torch_dtype(dtype),
                          device=device)
        return out.normal_(self.mean, self.std,
                           generator=framework_random.generator(device))


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device):
        out = torch.empty(tuple(shape), dtype=dtypes.to_torch_dtype(dtype),
                          device=device)
        return out.uniform_(self.low, self.high,
                            generator=framework_random.generator(device))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, device)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, device)
