"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer/``):
``Constant``, ``Normal``, ``TruncatedNormal``, ``Uniform``, the Xavier and
Kaiming pairs, ``Assign``, ``Orthogonal``, ``Dirac``, ``Bilinear``,
``calculate_gain`` and ``set_global_initializer``.  Each draws on the
device it is asked for from the framework's generator there
(``framework/random.py``), in the asked type; the values differ from
``jax.random``'s, their distribution does not.

``set_global_initializer(w, b)`` sets the initializers that every
``create_parameter`` of the port takes when its ``ParamAttr`` names none
(before the layer's own default), JAX's priority; ``(None, None)`` puts
the defaults back.  ``Orthogonal`` is JAX's ``orthogonal()`` (the QR of a
normal draw, signs fixed by R's diagonal) and ``Dirac`` its
``delta_orthogonal()`` for 3-5-D shapes (an orthogonal matrix at the
kernel's centre, zeros elsewhere), ``eye`` for 2-D ones."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ...framework import dtype as dtypes
from ...framework import random as framework_random

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Orthogonal", "Dirac", "Bilinear", "calculate_gain",
           "set_global_initializer"]


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


def calculate_gain(nonlinearity: str, param=None) -> float:
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity not in gains:
        raise ValueError(f"unsupported nonlinearity {nonlinearity}")
    return gains[nonlinearity]


def _empty(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=dtypes.to_torch_dtype(dtype),
                       device=device)


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


class TruncatedNormal(Initializer):
    """``mean + std * z`` with z a standard normal truncated to [a, b]."""

    def __init__(self, mean: float = 0.0, std: float = 1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype, device):
        out = _empty(shape, dtype, device)
        z = torch.empty(out.shape, dtype=torch.float32, device=device)
        gen = framework_random.generator(device)
        # inverse CDF over [Phi(a), Phi(b)], as jax.random.truncated_normal
        lo = 0.5 * (1 + math.erf(self.a / math.sqrt(2)))
        hi = 0.5 * (1 + math.erf(self.b / math.sqrt(2)))
        z.uniform_(lo, hi, generator=gen)
        z = math.sqrt(2) * torch.erfinv(2 * z - 1)
        z = z.clamp(self.a, self.b)
        return out.copy_(self.mean + self.std * z)


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _scale(self, shape):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        return calculate_gain(self.nonlinearity, self.negative_slope) / \
            math.sqrt(fi)


class KaimingNormal(_Kaiming):
    def __call__(self, shape, dtype, device):
        return Normal(0.0, self._scale(shape))(shape, dtype, device)


class KaimingUniform(_Kaiming):
    def __call__(self, shape, dtype, device):
        limit = self._scale(shape) * math.sqrt(3.0)
        return Uniform(-limit, limit)(shape, dtype, device)


class Assign(Initializer):
    """The given value (a Tensor, array or list), reshaped to ``shape``."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype, device):
        v = self.value
        v = getattr(v, "_data", v)
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        return v.detach().to(device=device, dtype=dtypes.to_torch_dtype(
            dtype), copy=True).reshape(tuple(shape))


def _orthogonal(shape, gen, device):
    """jax.nn.initializers.orthogonal(column_axis=-1) in f32: a [rows,
    cols] normal draw (the smaller side first), Q of its QR with the signs
    of R's diagonal."""
    cols = shape[-1]
    rows = math.prod(shape) // cols
    n, m = (rows, cols) if rows < cols else (cols, rows)
    a = torch.empty((m, n), dtype=torch.float32, device=device)
    a.normal_(generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return q.reshape(tuple(shape[:-1]) + (cols,))


class Orthogonal(Initializer):
    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, dtype, device):
        q = _orthogonal(list(shape), framework_random.generator(device),
                        device)
        return (self.gain * q).to(dtypes.to_torch_dtype(dtype))


class Dirac(Initializer):
    """JAX's choice: ``delta_orthogonal()`` for a 3-5-D kernel ``[.., in,
    out]``-ordered as jax.nn.initializers' (an orthogonal [in, out] at the
    centre of the spatial axes), ``eye`` for a 2-D shape."""

    def __init__(self, groups: int = 1):
        self.groups = groups

    def __call__(self, shape, dtype, device):
        tdt = dtypes.to_torch_dtype(dtype)
        if len(shape) < 3:
            return torch.eye(shape[0], shape[1], dtype=tdt, device=device)
        if len(shape) > 5:
            raise ValueError("Dirac takes 3-5-D shapes")
        if shape[-2] > shape[-1]:
            raise ValueError("Dirac needs in channels <= out channels "
                             "(shape[-2] <= shape[-1])")
        ortho = _orthogonal([shape[-2], shape[-1]],
                            framework_random.generator(device), device)
        out = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
        centre = tuple((k - 1) // 2 for k in shape[:-2])
        out[centre] = ortho
        return out.to(tdt)


class Bilinear(Initializer):
    """Bilinear-interpolation kernels for transposed-conv upsampling: each
    [kh, kw] slice of a 4-D shape is the tent filter's weight grid."""

    def __call__(self, shape, dtype, device):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer requires a 4-D shape")
        kh, kw = shape[2], shape[3]
        fh, fw = (kh + 1) // 2, (kw + 1) // 2
        ch = (2 * fh - 1 - fh % 2) / (2.0 * fh)
        cw = (2 * fw - 1 - fw % 2) / (2.0 * fw)
        yy = 1 - (torch.arange(kh, dtype=torch.float64, device=device)
                  / fh - ch).abs()
        xx = 1 - (torch.arange(kw, dtype=torch.float64, device=device)
                  / fw - cw).abs()
        kern = (yy[:, None] * xx[None, :]).to(dtypes.to_torch_dtype(dtype))
        return kern.expand(tuple(shape)).clone()


_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """Initializers for the parameters created afterwards whose
    ``ParamAttr`` names none; ``(None, None)`` restores the defaults."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def _global_initializer(is_bias):
    return _global_bias_init if is_bias else _global_weight_init
