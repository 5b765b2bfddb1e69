"""Comparisons and logic (counterpart of ``paddle_tpu/tensor/logic.py``):
the elementwise comparisons, ``equal_all`` / ``allclose`` / ``isclose``
(0-d bool results, as JAX's), ``is_empty``, ``where`` and ``where_``."""

from __future__ import annotations

import torch

from ..ops.dispatch import apply, as_tensor
from .math import (_make_binary, logical_and, logical_not,  # noqa: F401
                   logical_or, logical_xor)
from .tensor import Tensor, is_tensor, wrap_array  # noqa: F401

__all__ = ["equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal", "equal_all", "allclose", "isclose", "is_empty",
           "where", "where_", "logical_and", "logical_or", "logical_not",
           "logical_xor", "is_tensor"]

equal = _make_binary("equal", torch.eq, [])
not_equal = _make_binary("not_equal", torch.ne, [])
less_than = _make_binary("less_than", torch.lt, [])
less_equal = _make_binary("less_equal", torch.le, [])
greater_than = _make_binary("greater_than", torch.gt, [])
greater_equal = _make_binary("greater_equal", torch.ge, [])


def equal_all(x, y, name=None):
    """One bool: the same shape and every element equal."""
    def fn(a, b):
        if a.shape != b.shape:
            return torch.zeros((), dtype=torch.bool, device=a.device)
        return torch.eq(a, b).all()
    return apply("equal_all", fn, as_tensor(x), as_tensor(y))


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply("allclose", lambda a, b: torch.isclose(
        a, b, rtol=rtol, atol=atol, equal_nan=equal_nan).all(),
        as_tensor(x), as_tensor(y))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply("isclose", lambda a, b: torch.isclose(
        a, b, rtol=rtol, atol=atol, equal_nan=equal_nan),
        as_tensor(x), as_tensor(y))


def is_empty(x, name=None):
    x = as_tensor(x)
    return wrap_array(torch.tensor(x._data.numel() == 0,
                                   device=x._data.device))


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition``, else ``y``; with neither,
    ``nonzero(condition, as_tuple=True)``."""
    cond = as_tensor(condition)
    if x is None and y is None:
        from .search import nonzero
        return nonzero(cond, as_tuple=True)
    if isinstance(x, (int, float)) and isinstance(y, Tensor):
        xv = x
        return apply("where", lambda c, b: torch.where(
            c.bool(), torch.full((), xv, dtype=b.dtype, device=b.device), b),
            cond, y)
    if isinstance(y, (int, float)) and isinstance(x, Tensor):
        yv = y
        return apply("where", lambda c, a: torch.where(
            c.bool(), a, torch.full((), yv, dtype=a.dtype, device=a.device)),
            cond, x)
    return apply("where", lambda c, a, b: torch.where(c.bool(), a, b),
                 cond, as_tensor(x), as_tensor(y))


def where_(condition, x=None, y=None, name=None):
    return x._inplace_assign(where(condition, x, y))
