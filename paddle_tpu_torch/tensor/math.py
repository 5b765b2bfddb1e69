"""Elementwise math and reductions.

Counterpart of ``paddle_tpu/tensor/math.py`` for the ops the Layer API and
the training loop use: the binary arithmetic (a Python scalar operand is
closed over, so it takes the tensor's type, as JAX's weak types do),
``pow``, ``maximum``, the unary ``exp`` / ``log`` / ``sqrt`` / ``abs`` /
``neg`` / ``tanh``, and the reductions ``sum`` / ``mean`` / ``max``.
"""

from __future__ import annotations

import torch

from ..framework import dtype as dtypes
from ..ops.dispatch import apply, as_tensor
from .tensor import Tensor

__all__ = []


def _normalize_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a.item()) if isinstance(a, Tensor) else int(a)
                     for a in axis)
    return int(axis)


def _make_unary(name, tfn):
    def op(x, name=None):
        return apply(op.__name__, tfn, as_tensor(x))
    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"Elementwise {name}."
    __all__.append(name)
    return op


exp = _make_unary("exp", torch.exp)
log = _make_unary("log", torch.log)
sqrt = _make_unary("sqrt", torch.sqrt)
abs = _make_unary("abs", torch.abs)
neg = _make_unary("neg", torch.neg)
tanh = _make_unary("tanh", torch.tanh)


def _make_binary(name, tfn, exports=None):
    def op(x, y, name=None):
        scalar = (bool, int, float)
        if isinstance(x, Tensor) and isinstance(y, scalar):
            return apply(op.__name__, lambda a: tfn(a, y), x)
        if isinstance(y, Tensor) and isinstance(x, scalar):
            # torch ops take no Python scalar first; a 0-d tensor takes
            # the other operand's type as the scalar would
            return apply(op.__name__,
                         lambda b: tfn(torch.as_tensor(x, device=b.device),
                                       b), y)
        return apply(op.__name__, tfn, as_tensor(x), as_tensor(y))
    op.__name__ = op.__qualname__ = name
    (__all__ if exports is None else exports).append(name)
    return op


add = _make_binary("add", torch.add)
subtract = _make_binary("subtract", torch.sub)
multiply = _make_binary("multiply", torch.mul)
divide = _make_binary("divide", torch.true_divide)
pow = _make_binary("pow", torch.pow)
maximum = _make_binary("maximum", torch.maximum)


def _make_reduce(name, tfn, has_dtype=False):
    def op(x, axis=None, dtype=None, keepdim=False, name=None):
        ax = _normalize_axis(axis)
        tdt = dtypes.to_torch_dtype(dtype) if has_dtype else None

        def fn(a):
            if tdt is not None:
                a = a.to(tdt)
            if ax is None:
                out = tfn(a)
                return out.reshape([1] * a.dim()) if keepdim else out
            return tfn(a, dim=ax, keepdim=keepdim)

        return apply(op.__name__, fn, as_tensor(x))
    op.__name__ = op.__qualname__ = name
    __all__.append(name)
    return op


sum = _make_reduce("sum", torch.sum, has_dtype=True)


def _amax(a, dim=None, keepdim=False):
    return torch.amax(a) if dim is None else torch.amax(a, dim, keepdim)


max = _make_reduce("max", _amax)


def mean(x, axis=None, keepdim=False, name=None):
    ax = _normalize_axis(axis)

    def fn(a):
        if ax is None:
            out = torch.mean(a)
            return out.reshape([1] * a.dim()) if keepdim else out
        return torch.mean(a, dim=ax, keepdim=keepdim)

    return apply("mean", fn, as_tensor(x))


__all__.append("mean")
