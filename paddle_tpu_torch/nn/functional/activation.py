"""nn.functional's activations beyond ``relu`` / ``silu`` / ``gelu`` /
``tanh`` / ``softmax`` (counterpart of the activation block of
``paddle_tpu/nn/functional/__init__.py``).

Each is an elementwise torch op under JAX's op name, evaluating JAX's
formula: ``hardsigmoid`` is clip(x / 6 + 0.5, 0, 1), ``hardswish``
x * clip(x + 3, 0, 6) / 6, ``selu`` takes JAX's constants, ``mish`` and
``softplus`` use log(1 + e^x) as ``logaddexp(x, 0)``.  ``rrelu`` in
training and ``gumbel_softmax`` draw from the framework's generator of
the input's device.  The ``_`` forms rebind the handle, as the tensor
ops' do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...framework import random as framework_random
from ...ops.dispatch import apply, as_tensor
from ...tensor.math import sigmoid, tanh  # noqa: F401 (F.sigmoid)

__all__ = ["relu_", "relu6", "leaky_relu", "prelu", "elu", "selu", "celu",
           "swish", "mish", "hardshrink", "hardsigmoid", "hardswish",
           "hardtanh", "softshrink", "softsign", "tanhshrink",
           "thresholded_relu", "log_sigmoid", "maxout", "softplus",
           "sigmoid", "gumbel_softmax", "glu", "rrelu", "elu_", "hardtanh_",
           "leaky_relu_", "softmax_", "tanh_", "thresholded_relu_"]


def _zero(a):
    return torch.zeros((), dtype=a.dtype, device=a.device)


def _softplus0(a):
    return torch.logaddexp(a, _zero(a))


def _act(name, tfn):
    def op(x, name=None):
        return apply(op.__name__, tfn, as_tensor(x))
    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"Elementwise {name}."
    return op


relu6 = _act("relu6", lambda a: torch.clamp(a, 0.0, 6.0))
swish = _act("swish", TF.silu)
mish = _act("mish", lambda a: a * torch.tanh(_softplus0(a)))
softsign = _act("softsign", lambda a: a / (a.abs() + 1))
tanhshrink = _act("tanhshrink", lambda a: a - torch.tanh(a))
log_sigmoid = _act("log_sigmoid", TF.logsigmoid)
hardsigmoid = _act("hardsigmoid",
                   lambda a: torch.clamp(a / 6.0 + 0.5, 0.0, 1.0))
hardswish = _act("hardswish",
                 lambda a: a * torch.clamp(a + 3.0, 0.0, 6.0) / 6.0)


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply("leaky_relu", lambda a: torch.where(
        a >= 0, a, negative_slope * a), as_tensor(x))


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where positive, ``weight * x`` elsewhere; a weight of more
    than one element is per channel (axis 1, or the last for a
    channel-last ``data_format``)."""
    def fn(a, w):
        if w.numel() > 1:
            shape = [1] * a.dim()
            shape[1 if data_format[1] == "C" else a.dim() - 1] = w.numel()
            w = w.reshape(shape)
        return torch.where(a >= 0, a, w * a)
    return apply("prelu", fn, as_tensor(x), as_tensor(weight))


def elu(x, alpha=1.0, name=None):
    return apply("elu", lambda a: TF.elu(a, alpha), as_tensor(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply("selu", lambda a: scale * torch.where(
        a > 0, a, alpha * torch.expm1(a)), as_tensor(x))


def celu(x, alpha=1.0, name=None):
    return apply("celu", lambda a: TF.celu(a, alpha), as_tensor(x))


def hardshrink(x, threshold=0.5, name=None):
    return apply("hardshrink", lambda a: torch.where(
        a.abs() > threshold, a, _zero(a)), as_tensor(x))


def softshrink(x, threshold=0.5, name=None):
    return apply("softshrink", lambda a: torch.sign(a) * torch.clamp(
        a.abs() - threshold, min=0.0), as_tensor(x))


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply("hardtanh", lambda a: torch.clamp(a, min, max),
                 as_tensor(x))


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply("thresholded_relu", lambda a: torch.where(
        a > threshold, a, torch.full((), value, dtype=a.dtype,
                                     device=a.device)), as_tensor(x))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply("softplus", lambda a: torch.where(
        a * beta > threshold, a, _softplus0(a * beta) / beta), as_tensor(x))


def maxout(x, groups, axis=1, name=None):
    x = as_tensor(x)
    ax = axis % x.ndim

    def fn(a):
        c = a.shape[ax]
        shape = a.shape[:ax] + (c // groups, groups) + a.shape[ax + 1:]
        return torch.amax(a.reshape(shape), dim=ax + 1)

    return apply("maxout", fn, x)


def glu(x, axis=-1, name=None):
    def fn(a):
        a1, a2 = torch.chunk(a, 2, dim=axis)
        return a1 * torch.sigmoid(a2)
    return apply("glu", fn, as_tensor(x))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with Gumbel(0, 1) noise g; ``hard``
    gives the one-hot argmax with the soft gradient (straight through)."""
    x = as_tensor(x)
    gen = framework_random.generator(x._data.device)

    def fn(a):
        u = torch.rand(a.shape, generator=gen, dtype=a.dtype,
                       device=a.device)
        tiny = torch.finfo(a.dtype).tiny
        g = -torch.log(-torch.log(u.clamp(min=tiny)))
        y = torch.softmax((a + g) / temperature, dim=axis)
        if hard:
            idx = torch.argmax(y, dim=axis, keepdim=True)
            y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
            y = y_hard + (y - y.detach())
        return y

    return apply("gumbel_softmax", fn, x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    """``x`` where non-negative, ``r * x`` elsewhere: r drawn from
    U(lower, upper) per element in training, (lower + upper) / 2 in
    inference."""
    x = as_tensor(x)
    if training:
        gen = framework_random.generator(x._data.device)

        def fn(a):
            r = torch.rand(a.shape, generator=gen, dtype=a.dtype,
                           device=a.device) * (upper - lower) + lower
            return torch.where(a >= 0, a, r * a)
    else:
        mid = (lower + upper) / 2.0

        def fn(a):
            return torch.where(a >= 0, a, mid * a)

    return apply("rrelu", fn, x)


def relu_(x, name=None):
    from . import relu
    return x._inplace_assign(relu(x))


def elu_(x, alpha=1.0, name=None):
    return x._inplace_assign(elu(x, alpha))


def hardtanh_(x, min=-1.0, max=1.0, name=None):
    return x._inplace_assign(hardtanh(x, min, max))


def leaky_relu_(x, negative_slope=0.01, name=None):
    return x._inplace_assign(leaky_relu(x, negative_slope))


def softmax_(x, axis=-1, dtype=None, name=None):
    from . import softmax
    return x._inplace_assign(softmax(x, axis, dtype))


def tanh_(x, name=None):
    return x._inplace_assign(tanh(x))


def thresholded_relu_(x, threshold=1.0, value=0.0, name=None):
    return x._inplace_assign(thresholded_relu(x, threshold, value))



