"""Shape and indexing ops: ``reshape``, ``transpose``, ``concat``,
``split``, ``squeeze`` / ``unsqueeze``, ``repeat_interleave``, ``flatten``,
``cast`` / ``astype`` and ``__getitem__``.

Counterpart of the same functions of ``paddle_tpu/tensor/manipulation.py``.
Indexing keeps JAX's rules where torch differs: an integer index out of
range raises, and a bool mask selects on the host's dynamic shape.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as dtypes
from ..ops.dispatch import apply, as_tensor
from .creation import _shape_list
from .tensor import Tensor

__all__ = ["reshape", "transpose", "concat", "stack", "split", "squeeze",
           "unsqueeze", "repeat_interleave", "flatten", "cast", "astype",
           "getitem", "tolist"]


def _axes(axis):
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def reshape(x, shape, name=None):
    sh = tuple(_shape_list(shape))
    return apply("reshape", lambda a: a.reshape(sh), as_tensor(x))


def transpose(x, perm=None, name=None):
    x = as_tensor(x)
    if perm is None:
        perm = list(range(x.ndim))[::-1]
    p = tuple(_shape_list(perm))
    return apply("transpose", lambda a: a.permute(p), x)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = as_tensor(x)
    if x.ndim == 0:
        return reshape(x, [1])
    return apply("flatten",
                 lambda a: a.flatten(start_axis % a.dim(), stop_axis % a.dim()),
                 x)


def squeeze(x, axis=None, name=None):
    x = as_tensor(x)
    if axis is None:
        return apply("squeeze", lambda a: a.squeeze(), x)
    ax = _axes(axis)
    ax = (ax,) if isinstance(ax, int) else ax
    ax = tuple(a % x.ndim for a in ax if x.shape[a] == 1)
    return apply("squeeze", lambda a: a.squeeze(ax) if ax else a, x)


def unsqueeze(x, axis, name=None):
    ax = _axes(axis)
    ax = (ax,) if isinstance(ax, int) else ax

    def fn(a):
        for i in sorted(b % (a.dim() + len(ax)) for b in ax):
            a = a.unsqueeze(i)
        return a

    return apply("unsqueeze", fn, as_tensor(x))


def concat(x, axis=0, name=None):
    ts = [as_tensor(t) for t in x]
    ax = int(axis.item()) if isinstance(axis, Tensor) else int(axis)
    return apply("concat", lambda *arrs: torch.cat(arrs, dim=ax), *ts)


def stack(x, axis=0, name=None):
    ts = [as_tensor(t) for t in x]
    ax = int(axis.item()) if isinstance(axis, Tensor) else int(axis)
    return apply("stack", lambda *arrs: torch.stack(arrs, dim=ax), *ts)


def split(x, num_or_sections, axis=0, name=None):
    x = as_tensor(x)
    ax = int(axis.item()) if isinstance(axis, Tensor) else int(axis)
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise ValueError(
                f"paddle.split: axis size {dim} is not divisible by "
                f"num={num_or_sections} (reference requires even split)")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = _shape_list(num_or_sections)
        if sizes.count(-1) > 1:
            raise ValueError("paddle.split: at most one section may be -1")
        if -1 in sizes:
            sizes[sizes.index(-1)] = dim - (sum(sizes) + 1)
    if sum(sizes) != dim:
        raise ValueError(f"paddle.split: sections {sizes} do not sum to the "
                         f"axis size {dim}")
    return list(apply("split", lambda a: tuple(torch.split(a, sizes, ax)),
                      x))


def repeat_interleave(x, repeats, axis=None, name=None):
    x = as_tensor(x)
    if isinstance(repeats, Tensor):
        reps = repeats._data.to(x._data.device)
        return apply("repeat_interleave",
                     lambda a: torch.repeat_interleave(a, reps, dim=axis), x)
    r = int(repeats)
    if axis is None:
        return apply("repeat_interleave",
                     lambda a: torch.repeat_interleave(a.reshape(-1), r), x)
    return apply("repeat_interleave",
                 lambda a: torch.repeat_interleave(a, r, dim=int(axis)), x)


def cast(x, dtype):
    x = as_tensor(x)
    tdt = dtypes.to_torch_dtype(dtype)
    return apply("cast", lambda a: a if a.dtype == tdt else a.to(tdt), x)


def astype(x, dtype):
    return cast(x, dtype)


def tolist(x):
    return as_tensor(x).numpy().tolist()


def _normalize_index(item, device):
    """A Paddle index as a torch one: Tensors as their data (bool masks
    on the tensor's device), numpy arrays as tensors, lists of ints as
    index tensors."""
    def one(i):
        if isinstance(i, Tensor):
            return i._data.to(device)
        if isinstance(i, np.ndarray):
            return torch.from_numpy(i).to(device)
        if isinstance(i, list):
            return torch.as_tensor(i, device=device)
        return i
    if isinstance(item, tuple):
        return tuple(one(i) for i in item)
    return one(item)


def _check_int_bounds(idx, shape):
    """Integer indices out of range raise, as in Paddle (JAX clamps, so
    the JAX package checks too)."""
    items = idx if isinstance(idx, tuple) else (idx,)
    dim = 0
    for i in items:
        if i is None:
            continue
        if i is Ellipsis:
            dim = len(shape) - sum(
                1 for j in items if j is not None and j is not Ellipsis) + \
                dim
            continue
        if isinstance(i, (int, np.integer)) and dim < len(shape):
            n = shape[dim]
            if not -n <= int(i) < n:
                raise IndexError(f"index {int(i)} is out of bounds for axis "
                                 f"{dim} with size {n}")
        dim += 1


def getitem(x, item):
    x = as_tensor(x)
    idx = _normalize_index(item, x._data.device)
    _check_int_bounds(idx, x.shape)
    return apply("getitem", lambda a: a[idx], x)
