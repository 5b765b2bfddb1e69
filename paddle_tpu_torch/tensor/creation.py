"""Tensor creation ops: ``to_tensor``, ``zeros``, ``ones``, ``full``,
``zeros_like``, ``arange``, ``randint``, ``randn`` and ``clone``.

Counterpart of the same functions of ``paddle_tpu/tensor/creation.py`` and
``tensor/random.py``.  New tensors go to the current place; the random ones
draw from the framework's generator of that device
(``framework/random.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as dtypes
from ..framework import place as places
from ..framework import random as framework_random
from ..ops.dispatch import as_tensor
from .tensor import Tensor, to_tensor, wrap_array  # noqa: F401 (re-export)

__all__ = ["to_tensor", "zeros", "ones", "full", "zeros_like", "arange",
           "randint", "randn", "clone"]


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


def zeros(shape, dtype=None, name=None) -> Tensor:
    return wrap_array(torch.zeros(_shape_list(shape), dtype=_dt(dtype),
                                  device=_dev()))


def ones(shape, dtype=None, name=None) -> Tensor:
    return wrap_array(torch.ones(_shape_list(shape), dtype=_dt(dtype),
                                 device=_dev()))


def full(shape, fill_value, dtype=None, name=None) -> Tensor:
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    if dtype is None:
        dtype = "bool" if isinstance(fill_value, bool) else \
            dtypes.default_float_dtype()
    return wrap_array(torch.full(_shape_list(shape), fill_value,
                                 dtype=_dt(dtype), device=_dev()))


def zeros_like(x, dtype=None, name=None) -> Tensor:
    x = as_tensor(x)
    return wrap_array(torch.zeros_like(x._data,
                                       dtype=dtypes.to_torch_dtype(dtype)))


def arange(start=0, end=None, step=1, dtype=None, name=None) -> Tensor:
    start, end, step = (v.item() if isinstance(v, Tensor) else v
                        for v in (start, end, step))
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = dtypes.default_float_dtype() if any(
            isinstance(v, float) for v in (start, end, step)) else "int64"
    return wrap_array(torch.arange(start, end, step, dtype=_dt(dtype),
                                   device=_dev()))


def randint(low=0, high=None, shape=(1,), dtype=None, name=None) -> Tensor:
    if high is None:
        low, high = 0, low
    dev = _dev()
    return wrap_array(torch.randint(
        int(low), int(high), _shape_list(shape),
        generator=framework_random.generator(dev), dtype=_dt(dtype, "int64"),
        device=dev))


def randn(shape, dtype=None, name=None) -> Tensor:
    dev = _dev()
    return wrap_array(torch.randn(
        _shape_list(shape), generator=framework_random.generator(dev),
        dtype=_dt(dtype), device=dev))


def clone(x, name=None) -> Tensor:
    return wrap_array(as_tensor(x)._data.clone())
