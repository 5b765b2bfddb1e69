"""Tensor creation ops.

Counterpart of ``paddle_tpu/tensor/creation.py``.  New tensors go to the
current place; ``*_like`` ones go where their model tensor is.  Types
follow JAX's: ``full`` of a Python int is the default float type, ``eye``,
``linspace`` and ``logspace`` the default float type, the index tables
int64.  ``empty`` is zeros, as JAX's is.  ``cauchy_`` draws from the
framework's generator of the tensor's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..framework import dtype as dtypes
from ..framework import place as places
from ..framework import random as framework_random
from ..ops.dispatch import apply, as_tensor
from .tensor import Tensor, to_tensor, wrap_array  # noqa: F401 (re-export)

__all__ = [
    "to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "empty", "empty_like", "arange", "linspace", "logspace",
    "eye", "diag", "diagflat", "tril", "triu", "tril_indices",
    "triu_indices", "meshgrid", "assign", "clone", "numel",
    "complex", "polar", "as_tensor_", "diag_embed", "vander",
    "create_parameter", "ones_like_", "cauchy_",
]


def _shape_list(shape):
    if isinstance(shape, Tensor):
        return [int(s) for s in shape.tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s.item()) if isinstance(s, Tensor) else int(s)
            for s in shape]


def _dt(dtype, default=None):
    if dtype is None:
        dtype = default or dtypes.default_float_dtype()
    return dtypes.to_torch_dtype(dtype)


def _dev():
    return places.current_torch_device()


def _item(v):
    return v.item() if isinstance(v, Tensor) else v


def zeros(shape, dtype=None, name=None) -> Tensor:
    return wrap_array(torch.zeros(_shape_list(shape), dtype=_dt(dtype),
                                  device=_dev()))


def ones(shape, dtype=None, name=None) -> Tensor:
    return wrap_array(torch.ones(_shape_list(shape), dtype=_dt(dtype),
                                 device=_dev()))


def full(shape, fill_value, dtype=None, name=None) -> Tensor:
    fill_value = _item(fill_value)
    if dtype is None:
        dtype = "bool" if isinstance(fill_value, bool) else \
            dtypes.default_float_dtype()
    return wrap_array(torch.full(_shape_list(shape), fill_value,
                                 dtype=_dt(dtype), device=_dev()))


def zeros_like(x, dtype=None, name=None) -> Tensor:
    return wrap_array(torch.zeros_like(as_tensor(x)._data,
                                       dtype=dtypes.to_torch_dtype(dtype)))


def ones_like(x, dtype=None, name=None) -> Tensor:
    return wrap_array(torch.ones_like(as_tensor(x)._data,
                                      dtype=dtypes.to_torch_dtype(dtype)))


ones_like_ = ones_like


def full_like(x, fill_value, dtype=None, name=None) -> Tensor:
    return wrap_array(torch.full_like(as_tensor(x)._data, _item(fill_value),
                                      dtype=dtypes.to_torch_dtype(dtype)))


def empty(shape, dtype=None, name=None) -> Tensor:
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None) -> Tensor:
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None) -> Tensor:
    start, end, step = (_item(v) for v in (start, end, step))
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = dtypes.default_float_dtype() if any(
            isinstance(v, float) for v in (start, end, step)) else "int64"
    return wrap_array(torch.arange(start, end, step, dtype=_dt(dtype),
                                   device=_dev()))


def linspace(start, stop, num, dtype=None, name=None) -> Tensor:
    start, stop, num = _item(start), _item(stop), int(_item(num))
    # in float64 first, as numpy's and JAX's evaluation of the same points
    vals = torch.linspace(float(start), float(stop), num,
                          dtype=torch.float64, device=_dev())
    return wrap_array(vals.to(_dt(dtype)))


def logspace(start, stop, num, base=10.0, dtype=None, name=None) -> Tensor:
    start, stop, num = _item(start), _item(stop), int(_item(num))
    vals = torch.logspace(float(start), float(stop), num, base=base,
                          dtype=torch.float64, device=_dev())
    return wrap_array(vals.to(_dt(dtype)))


def eye(num_rows, num_columns=None, dtype=None, name=None) -> Tensor:
    ncols = int(num_columns) if num_columns is not None else int(num_rows)
    return wrap_array(torch.eye(int(num_rows), ncols, dtype=_dt(dtype),
                                device=_dev()))


def diag(x, offset=0, padding_value=0, name=None) -> Tensor:
    def fn(a):
        d = torch.diag(a, offset)
        if a.dim() == 1 and padding_value != 0:
            mask = torch.ones(d.shape[0], d.shape[1], dtype=torch.bool,
                              device=a.device)
            mask = torch.diag(torch.diagonal(mask, offset), offset).bool()
            return torch.where(mask, d, torch.full((), padding_value,
                                                   dtype=d.dtype,
                                                   device=a.device))
        return d
    return apply("diag", fn, as_tensor(x))


def diagflat(x, offset=0, name=None) -> Tensor:
    return apply("diagflat", lambda a: torch.diagflat(a, offset),
                 as_tensor(x))


def diag_embed(input, offset=0, dim1=-2, dim2=-1) -> Tensor:
    return apply("diag_embed", lambda a: torch.diag_embed(
        a, offset=offset, dim1=dim1, dim2=dim2), as_tensor(input))


def tril(x, diagonal=0, name=None) -> Tensor:
    return apply("tril", lambda a: torch.tril(a, diagonal), as_tensor(x))


def triu(x, diagonal=0, name=None) -> Tensor:
    return apply("triu", lambda a: torch.triu(a, diagonal), as_tensor(x))


def _tri_indices(tfn, row, col, offset, dtype):
    col = col if col is not None else row
    return wrap_array(tfn(int(row), int(col), offset, device=_dev()).to(
        dtypes.to_torch_dtype(dtype)))


def tril_indices(row, col=None, offset=0, dtype="int64") -> Tensor:
    return _tri_indices(torch.tril_indices, row, col, offset, dtype)


def triu_indices(row, col=None, offset=0, dtype="int64") -> Tensor:
    return _tri_indices(torch.triu_indices, row, col, offset, dtype)


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    ts = [as_tensor(a) for a in args]
    return list(apply("meshgrid", lambda *arrs: tuple(
        torch.meshgrid(*arrs, indexing="ij")), *ts))


def assign(x, output=None) -> Tensor:
    """A copy of ``x`` (a Tensor, array, list or scalar), written into
    ``output`` when given."""
    src = as_tensor(x) if not isinstance(
        x, (np.ndarray, list, tuple, int, float)) else as_tensor(
        np.asarray(x))
    out = apply("assign", lambda a: a.clone(), src)
    if output is not None:
        output._inplace_assign(out)
        return output
    return out


def clone(x, name=None) -> Tensor:
    return apply("clone", lambda a: a.clone(), as_tensor(x))


def numel(x, name=None) -> Tensor:
    x = as_tensor(x)
    return wrap_array(torch.tensor(x._data.numel(), dtype=torch.int64,
                                   device=x._data.device))


def complex(real, imag, name=None) -> Tensor:
    return apply("complex", torch.complex, as_tensor(real), as_tensor(imag))


def polar(abs, angle, name=None) -> Tensor:
    return apply("polar", lambda r, t: torch.complex(
        r * torch.cos(t), r * torch.sin(t)), as_tensor(abs), as_tensor(angle))


def vander(x, n=None, increasing=False, name=None) -> Tensor:
    def fn(a):
        cols = a.shape[0] if n is None else int(n)
        powers = torch.arange(cols, device=a.device)
        if not increasing:
            powers = powers.flip(0)
        return a[:, None] ** powers.to(a.dtype)
    return apply("vander", fn, as_tensor(x))


def as_tensor_(data, dtype=None, place=None):
    return to_tensor(data, dtype=dtype, place=place)


def cauchy_(x, loc=0, scale=1, name=None):
    """Fill ``x`` with Cauchy(loc, scale) draws, in place."""
    d = x._data
    gen = framework_random.generator(d.device)
    with torch.no_grad():
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32,
                       device=d.device)
        vals = loc + scale * torch.tan(math.pi * (u - 0.5))
        return x._inplace_assign(wrap_array(vals.to(d.dtype)))


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A trainable Parameter on the current place: ``default_initializer``
    (zeros for a bias, XavierNormal otherwise, as JAX's), or
    ``set_global_initializer``'s where one is set (JAX's function takes
    ``default_initializer`` alone, whatever the global initializer)."""
    from ..framework.param import Parameter
    from ..nn import initializer as I
    init = I._global_initializer(is_bias) or default_initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    return Parameter(init(_shape_list(shape), dtype, _dev()), dtype=dtype,
                     name=name)
