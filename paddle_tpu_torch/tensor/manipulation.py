"""Shape, layout, gather / scatter and indexing ops.

Counterpart of ``paddle_tpu/tensor/manipulation.py``.  JAX's semantics are
kept where torch's differ:

* ``gather`` is an index-select along ``axis`` (negative indices wrap),
  not ``torch.gather``.
* A write with duplicate indices keeps the later row (``scatter`` with
  ``overwrite=True``, ``index_put``, ``put_along_axis(reduce="assign")``),
  as JAX's serial scatter does.  On the card torch's own order is not
  fixed, so :func:`_put_last` first gives every duplicate the last one's
  row: any order then writes the same bits.
* An integer index out of range raises, and a bool mask selects on the
  host's dynamic shape.
* ``unique`` / ``unique_consecutive`` / ``nonzero`` / ``masked_select``
  have data-dependent shapes and read the host, as JAX's do.
* ``view`` with a dtype casts, as JAX's does (it does not reinterpret
  bits).

In-place forms compute out of place and rebind the handle
(``Tensor._inplace_assign``).
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework import dtype as dtypes
from ..ops.dispatch import apply, as_tensor
from .creation import _shape_list
from .tensor import Tensor, wrap_array

__all__ = [
    "reshape", "reshape_", "flatten", "flatten_", "transpose", "permute",
    "squeeze", "squeeze_", "unsqueeze", "unsqueeze_", "concat", "stack",
    "split", "tensor_split", "vsplit", "hsplit", "dsplit", "chunk",
    "unstack", "unbind", "tile", "expand", "expand_as", "broadcast_to",
    "broadcast_tensors", "broadcast_shape", "gather", "gather_nd",
    "scatter", "scatter_", "scatter_nd", "scatter_nd_add", "index_select",
    "index_sample", "index_add", "index_put", "masked_select", "masked_fill",
    "masked_scatter", "roll", "flip", "rot90", "unique",
    "unique_consecutive", "repeat_interleave", "take_along_axis",
    "put_along_axis", "slice", "strided_slice", "moveaxis", "swapaxes",
    "as_real", "as_complex", "cast", "cast_", "astype", "crop",
    "fill_diagonal_", "fill_", "zero_", "flip_", "t", "tolist",
    "atleast_1d", "atleast_2d", "atleast_3d", "view", "view_as",
    "as_strided", "tensordot", "rank", "shard_index", "getitem", "setitem",
    "select_scatter", "slice_scatter", "column_stack", "row_stack",
    "hstack", "vstack", "dstack", "pad_sequences",
]


def _axes(axis):
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a.item()) if isinstance(a, Tensor) else int(a)
                     for a in axis)
    return int(axis)


def _int(v):
    return int(v.item()) if isinstance(v, Tensor) else int(v)


def reshape(x, shape, name=None):
    sh = tuple(_shape_list(shape))
    return apply("reshape", lambda a: a.reshape(sh), as_tensor(x))


def reshape_(x, shape, name=None):
    return x._inplace_assign(reshape(x, shape))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return astype(x, shape_or_dtype)


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def as_strided(x, shape, stride, offset=0, name=None):
    sh, st = tuple(shape), tuple(stride)
    idx = np.zeros(sh, dtype=np.int64) + offset
    for d, (s, k) in enumerate(zip(sh, st)):
        idx += (np.arange(s) * k).reshape(
            [-1 if i == d else 1 for i in range(len(sh))])
    return apply("as_strided", lambda a: a.reshape(-1)[
        torch.from_numpy(idx).to(a.device)], as_tensor(x))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = as_tensor(x)
    if x.ndim == 0:
        return reshape(x, [1])
    return apply("flatten",
                 lambda a: a.flatten(start_axis % a.dim(), stop_axis % a.dim()),
                 x)


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return x._inplace_assign(flatten(x, start_axis, stop_axis))


def transpose(x, perm=None, name=None):
    x = as_tensor(x)
    if perm is None:
        perm = list(range(x.ndim))[::-1]
    p = tuple(_shape_list(perm))
    return apply("transpose", lambda a: a.permute(p), x)


permute = transpose


def t(x, name=None):
    x = as_tensor(x)
    if x.ndim < 2:
        return apply("t", lambda a: a, x)
    if x.ndim != 2:
        raise ValueError("paddle.t only supports 0/1/2-D tensors")
    return apply("t", lambda a: a.t(), x)


def moveaxis(x, source, destination, name=None):
    s, d = _axes(source), _axes(destination)
    return apply("moveaxis", lambda a: torch.movedim(a, s, d), as_tensor(x))


def swapaxes(x, axis1, axis2, name=None):
    return apply("swapaxes", lambda a: a.transpose(int(axis1), int(axis2)),
                 as_tensor(x))


def squeeze(x, axis=None, name=None):
    x = as_tensor(x)
    if axis is None:
        return apply("squeeze", lambda a: a.squeeze(), x)
    ax = _axes(axis)
    ax = (ax,) if isinstance(ax, int) else ax
    ax = tuple(a % x.ndim for a in ax if x.shape[a] == 1)
    return apply("squeeze", lambda a: a.squeeze(ax) if ax else a, x)


def squeeze_(x, axis=None, name=None):
    return x._inplace_assign(squeeze(x, axis))


def unsqueeze(x, axis, name=None):
    ax = _axes(axis)
    ax = (ax,) if isinstance(ax, int) else ax

    def fn(a):
        for i in sorted(b % (a.dim() + len(ax)) for b in ax):
            a = a.unsqueeze(i)
        return a

    return apply("unsqueeze", fn, as_tensor(x))


def unsqueeze_(x, axis, name=None):
    return x._inplace_assign(unsqueeze(x, axis))


def concat(x, axis=0, name=None):
    ts = [as_tensor(t) for t in x]
    ax = _int(axis)
    return apply("concat", lambda *arrs: torch.cat(arrs, dim=ax), *ts)


def stack(x, axis=0, name=None):
    ts = [as_tensor(t) for t in x]
    ax = _int(axis)
    return apply("stack", lambda *arrs: torch.stack(arrs, dim=ax), *ts)


def _stacker(name, tfn):
    def op(x, name=None):
        ts = [as_tensor(t) for t in x]
        return apply(op.__name__, lambda *arrs: tfn(arrs), *ts)
    op.__name__ = op.__qualname__ = name
    return op


hstack = _stacker("hstack", torch.hstack)
vstack = _stacker("vstack", torch.vstack)
dstack = _stacker("dstack", torch.dstack)
column_stack = _stacker("column_stack", torch.column_stack)
row_stack = vstack


def split(x, num_or_sections, axis=0, name=None):
    x = as_tensor(x)
    ax = _int(axis)
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
            sizes[sizes.index(-1)] = dim - (builtins.sum(sizes) + 1)
    if builtins.sum(sizes) != dim:
        raise ValueError(f"paddle.split: sections {sizes} do not sum to the "
                         f"axis size {dim}")
    return list(apply("split", lambda a: tuple(torch.split(a, sizes, ax)),
                      x))


def tensor_split(x, num_or_indices, axis=0, name=None):
    x = as_tensor(x)
    ax = int(axis)
    dim = x.shape[ax]
    if isinstance(num_or_indices, int):
        base, extra = divmod(dim, num_or_indices)
        sizes = [base + (1 if i < extra else 0)
                 for i in range(num_or_indices)]
        return split(x, sizes, axis=ax)
    bounds = [0] + _shape_list(num_or_indices) + [dim]
    sizes = [builtins.max(0, bounds[i + 1] - bounds[i])
             for i in range(len(bounds) - 1)]
    return split(x, sizes, axis=ax)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=1)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def unstack(x, axis=0, num=None, name=None):
    x = as_tensor(x)
    ax = int(axis) % x.ndim
    n = num or x.shape[ax]
    return list(apply("unstack", lambda a: tuple(
        a.select(ax, i) for i in range(n)), x))


def unbind(input, axis=0):
    return unstack(input, axis=axis)


def tile(x, repeat_times, name=None):
    reps = tuple(_shape_list(repeat_times))
    return apply("tile", lambda a: torch.tile(a, reps), as_tensor(x))


def expand(x, shape, name=None):
    x = as_tensor(x)
    sh = _shape_list(shape)
    cur = [1] * (len(sh) - x.ndim) + x.shape
    tgt = tuple(c if s == -1 else s for s, c in zip(sh, cur))
    return apply("expand", lambda a: a.expand(tgt), x)


def expand_as(x, y, name=None):
    return expand(x, as_tensor(y).shape)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(input, name=None):
    ts = [as_tensor(t) for t in input]
    return list(apply("broadcast_tensors",
                      lambda *arrs: tuple(torch.broadcast_tensors(*arrs)),
                      *ts))


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def cast(x, dtype):
    x = as_tensor(x)
    tdt = dtypes.to_torch_dtype(dtype)
    return apply("cast", lambda a: a if a.dtype == tdt else a.to(tdt), x)


def cast_(x, dtype):
    return x._inplace_assign(cast(x, dtype))


def astype(x, dtype):
    return cast(x, dtype)


def tolist(x):
    return as_tensor(x).numpy().tolist()


def rank(input):
    x = as_tensor(input)
    return wrap_array(torch.tensor(x.ndim, dtype=torch.int32,
                                   device=x._data.device))


# ---------------------------------------------------------------------------
# gather / scatter family
# ---------------------------------------------------------------------------
def _wrap_neg(i, n):
    i = i.long()
    return torch.where(i < 0, i + n, i)


def _put_last(a, idx, vals, accumulate=False):
    """``a`` with ``vals`` written at the advanced index ``idx`` (a tuple
    of integer tensors over ``a``'s leading axes); a duplicate position
    takes the row of its last occurrence, on any device."""
    if accumulate:
        return a.index_put(idx, vals, accumulate=True)
    k = len(idx)
    idx = tuple(_wrap_neg(i, a.shape[d]) for d, i in enumerate(idx))
    idx = torch.broadcast_tensors(*idx)
    lead = idx[0].shape
    lin = torch.zeros(lead, dtype=torch.long, device=a.device)
    for d, i in enumerate(idx):
        lin = lin * a.shape[d] + i
    lin = lin.reshape(-1)
    n = lin.numel()
    cells = 1
    for s in a.shape[:k]:
        cells *= s
    pos = torch.arange(n, device=a.device)
    last = torch.full((cells,), -1, dtype=torch.long,
                      device=a.device).scatter_reduce(
        0, lin, pos, "amax", include_self=True)
    vals = vals.to(a.dtype).expand(lead + a.shape[k:]).reshape(
        (n,) + a.shape[k:])
    # an earlier duplicate writes the last one's row, without a gradient
    # of its own: the last occurrence gets its output's gradient once
    won = (last[lin] == pos).reshape((n,) + (1,) * (vals.dim() - 1))
    src = torch.where(won, vals, vals[last[lin]].detach())
    flat = tuple(i.reshape(-1) for i in idx)
    return a.index_put(flat, src)


def gather(x, index, axis=0, name=None):
    ax = _int(axis)
    return apply("gather", lambda a, i: torch.index_select(
        a, ax, _wrap_neg(i.reshape(-1), a.shape[ax])),
        as_tensor(x), as_tensor(index))


def gather_nd(x, index, name=None):
    def fn(a, i):
        i = i.long()
        return a[tuple(_wrap_neg(i[..., d], a.shape[d])
                       for d in range(i.shape[-1]))]
    return apply("gather_nd", fn, as_tensor(x), as_tensor(index))


def scatter(x, index, updates, overwrite=True, name=None):
    """``x`` with the rows ``index`` set to ``updates`` (``overwrite``; a
    duplicate index keeps its later row) or set to the sum of their
    updates."""
    def fn(a, i, u):
        i = _wrap_neg(i.reshape(-1), a.shape[0])
        if overwrite:
            return _put_last(a, (i,), u)
        return a.index_fill(0, i, 0).index_add(0, i, u.to(a.dtype))
    return apply("scatter", fn, as_tensor(x), as_tensor(index),
                 as_tensor(updates))


def scatter_(x, index, updates, overwrite=True, name=None):
    return x._inplace_assign(scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    def fn(a, i, u):
        i = i.long()
        idx = tuple(_wrap_neg(i[..., d], a.shape[d])
                    for d in range(i.shape[-1]))
        return a.index_put(idx, u.to(a.dtype), accumulate=True)
    return apply("scatter_nd_add", fn, as_tensor(x), as_tensor(index),
                 as_tensor(updates))


def scatter_nd(index, updates, shape, name=None):
    from .creation import zeros
    return scatter_nd_add(zeros(shape, dtype=as_tensor(updates).dtype),
                          index, updates)


def index_select(x, index, axis=0, name=None):
    ax = int(axis)
    return apply("index_select", lambda a, i: torch.index_select(
        a, ax, _wrap_neg(i.reshape(-1), a.shape[ax])),
        as_tensor(x), as_tensor(index))


def index_sample(x, index):
    return apply("index_sample", lambda a, i: torch.gather(
        a, 1, _wrap_neg(i, a.shape[1])), as_tensor(x), as_tensor(index))


def index_add(x, index, axis, value, name=None):
    ax = int(axis)
    return apply("index_add", lambda a, i, v: torch.index_add(
        a, ax, _wrap_neg(i.reshape(-1), a.shape[ax]), v.to(a.dtype)),
        as_tensor(x), as_tensor(index), as_tensor(value))


def index_put(x, indices, value, accumulate=False, name=None):
    """``x`` with ``value`` written (or added) at the advanced index
    ``indices``; a duplicate position keeps its later value."""
    x = as_tensor(x)
    idx_ts = [as_tensor(i) for i in indices]

    def fn(a, vv, *idx):
        ii = []
        for i in idx:
            if i.dtype == torch.bool:
                ii.extend(torch.nonzero(i, as_tuple=True))
            else:
                ii.append(i)
        return _put_last(a, tuple(ii), vv, accumulate)

    return apply("index_put", fn, x, as_tensor(value), *idx_ts)


def masked_select(x, mask, name=None):
    def fn(a, m):
        return a[m.bool().expand(a.shape)]
    return apply("masked_select", fn, as_tensor(x), as_tensor(mask))


def masked_fill(x, mask, value, name=None):
    val = value.item() if isinstance(value, Tensor) and value.size == 1 \
        else value
    if isinstance(val, Tensor):
        return apply("masked_fill",
                     lambda a, m, v: torch.where(m.bool(), v, a),
                     as_tensor(x), as_tensor(mask), as_tensor(val))
    return apply("masked_fill", lambda a, m: torch.where(
        m.bool(), torch.full((), val, dtype=a.dtype, device=a.device), a),
        as_tensor(x), as_tensor(mask))


def masked_scatter(x, mask, value, name=None):
    x, mask = as_tensor(x), as_tensor(mask)
    m = mask._data.bool()
    return apply("masked_scatter", lambda a, v: a.masked_scatter(
        m.expand(a.shape), v.to(a.dtype)), x, as_tensor(value))


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    ax = int(axis)
    return apply("take_along_axis", lambda a, i: torch.take_along_dim(
        a, _wrap_neg(i, a.shape[ax]), dim=ax),
        as_tensor(arr), as_tensor(indices))


_REDUCE = {"add": "sum", "multiply": "prod", "mul": "prod", "amin": "amin",
           "amax": "amax"}


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    """``arr`` with ``values`` put at ``indices`` along ``axis``: assigned
    (a duplicate keeps its later value) or reduced into the element (add,
    multiply / mul, amin, amax; the element itself always takes part, as
    in JAX)."""
    ax = int(axis)
    if not isinstance(values, Tensor) and isinstance(values, (int, float)):
        vt = as_tensor(values)
        values = apply("full_like_idx", lambda i, v: torch.full_like(
            i, v.item(), dtype=v.dtype), as_tensor(indices), vt)

    def fn(a, i, v):
        i = _wrap_neg(i, a.shape[ax])
        v = v.to(a.dtype).expand(i.shape)
        if reduce == "assign":
            moved = a.movedim(ax, -1)
            im, vm = i.movedim(ax, -1), v.movedim(ax, -1)
            lead = torch.meshgrid(*[torch.arange(s, device=a.device)
                                    for s in im.shape[:-1]], indexing="ij")
            idx = tuple(l[..., None].expand(im.shape) for l in lead) + (im,)
            return _put_last(moved, idx, vm).movedim(-1, ax)
        return a.scatter_reduce(ax, i, v, _REDUCE[reduce], include_self=True)

    return apply("put_along_axis", fn, as_tensor(arr), as_tensor(indices),
                 as_tensor(values))


def select_scatter(x, values, axis, index, name=None):
    ax, i = int(axis), int(index)
    return apply("select_scatter", lambda a, v: torch.select_scatter(
        a, v.to(a.dtype), ax, i), as_tensor(x), as_tensor(values))


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    x = as_tensor(x)
    sl = [builtins.slice(None)] * x.ndim
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        sl[int(ax)] = builtins.slice(int(st), int(en), int(sd))
    sl = tuple(sl)

    def fn(a, v):
        out = a.clone()
        out[sl] = v.to(a.dtype)
        return out

    return apply("slice_scatter", fn, x, as_tensor(value))


def roll(x, shifts, axis=None, name=None):
    sh = _axes(shifts)
    ax = _axes(axis) if axis is not None else None
    if ax is None:
        return apply("roll", lambda a: torch.roll(a, sh), as_tensor(x))
    return apply("roll", lambda a: torch.roll(a, sh, ax), as_tensor(x))


def flip(x, axis, name=None):
    ax = _axes(axis)
    ax = (ax,) if isinstance(ax, int) else ax
    return apply("flip", lambda a: torch.flip(a, ax), as_tensor(x))


def flip_(x, axis, name=None):
    return x._inplace_assign(flip(x, axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    ax = tuple(_shape_list(axes))
    return apply("rot90", lambda a: torch.rot90(a, k, ax), as_tensor(x))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """Sorted unique values (of the flattened tensor, or the unique slices
    along ``axis``), with the first index of each, the inverse and the
    counts when asked; the index outputs in ``dtype``."""
    a = as_tensor(x)._data.detach()
    idt = dtypes.to_torch_dtype(dtype)
    ax = None if axis is None else int(axis)
    uniq, inv, counts = torch.unique(a, sorted=True, return_inverse=True,
                                     return_counts=True, dim=ax)
    if not (return_index or return_inverse or return_counts):
        return wrap_array(uniq)
    outs = [wrap_array(uniq)]
    if return_index:
        n = a.numel() if ax is None else a.shape[ax]
        flat_inv = inv.reshape(-1)
        first = torch.full((uniq.numel() if ax is None else
                            uniq.shape[ax],), n, dtype=torch.long,
                           device=a.device).scatter_reduce(
            0, flat_inv, torch.arange(n, device=a.device), "amin")
        outs.append(wrap_array(first.to(idt)))
    if return_inverse:
        outs.append(wrap_array(inv.to(idt)))
    if return_counts:
        outs.append(wrap_array(counts.to(idt)))
    return tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    a = as_tensor(x)._data.detach()
    idt = dtypes.to_torch_dtype(dtype)
    out, inv, counts = torch.unique_consecutive(
        a.reshape(-1) if axis is None else a, return_inverse=True,
        return_counts=True, dim=0 if axis is None else int(axis))
    result = [wrap_array(out)]
    if return_inverse:
        result.append(wrap_array(inv.to(idt)))
    if return_counts:
        result.append(wrap_array(counts.to(idt)))
    return result[0] if len(result) == 1 else tuple(result)


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


def slice(input, axes, starts, ends):
    input = as_tensor(input)
    idx = [builtins.slice(None)] * input.ndim
    for ax, st, en in zip(_shape_list(axes), _shape_list(starts),
                          _shape_list(ends)):
        idx[ax] = builtins.slice(st, en)
    tup = tuple(idx)
    return apply("slice", lambda a: a[tup], input)


def strided_slice(x, axes, starts, ends, strides, name=None):
    x = as_tensor(x)
    picks = {}
    for ax, st, en, sd in zip(_shape_list(axes), _shape_list(starts),
                              _shape_list(ends), _shape_list(strides)):
        ax = ax % x.ndim
        picks[ax] = torch.from_numpy(
            np.arange(x.shape[ax])[builtins.slice(st, en, sd)].copy())

    def fn(a):
        for ax, i in picks.items():
            a = torch.index_select(a, ax, i.to(a.device))
        return a

    return apply("strided_slice", fn, x)


def crop(x, shape=None, offsets=None, name=None):
    x = as_tensor(x)
    sh = _shape_list(shape) if shape is not None else x.shape
    off = _shape_list(offsets) if offsets is not None else [0] * x.ndim
    sh = [xs if s == -1 else s for s, xs in zip(sh, x.shape)]
    tup = tuple(builtins.slice(o, o + s) for o, s in zip(off, sh))
    return apply("crop", lambda a: a[tup], x)


def as_real(x, name=None):
    return apply("as_real", lambda a: torch.stack(
        [torch.real(a), torch.imag(a)], dim=-1), as_tensor(x))


def as_complex(x, name=None):
    return apply("as_complex", lambda a: torch.complex(a[..., 0], a[..., 1]),
                 as_tensor(x))


def _atleast(name, tfn):
    def op(*inputs, name=None):
        outs = [apply(op.__name__, tfn, as_tensor(x)) for x in inputs]
        return outs[0] if len(outs) == 1 else outs
    op.__name__ = op.__qualname__ = name
    return op


atleast_1d = _atleast("atleast_1d", torch.atleast_1d)
atleast_2d = _atleast("atleast_2d", torch.atleast_2d)
atleast_3d = _atleast("atleast_3d", torch.atleast_3d)


def fill_(x, value):
    with torch.no_grad():
        return x._inplace_assign(wrap_array(torch.full_like(x._data, value)))


def zero_(x):
    with torch.no_grad():
        return x._inplace_assign(wrap_array(torch.zeros_like(x._data)))


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    with torch.no_grad():
        out = x._data.detach().clone()
        out.fill_diagonal_(value, wrap=wrap)
        return x._inplace_assign(wrap_array(out))


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, Tensor):
        axes = axes.tolist()
    if isinstance(axes, (list, tuple)):
        ax = [_shape_list(a) if isinstance(a, (list, tuple)) else [int(a)]
              for a in axes]
    else:
        ax = int(axes)
    return apply("tensordot", lambda a, b: torch.tensordot(a, b, dims=ax),
                 as_tensor(x), as_tensor(y))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    size = (index_num + nshards - 1) // nshards

    def fn(i):
        return torch.where(i // size == shard_id, i % size,
                           torch.full((), ignore_value, dtype=i.dtype,
                                      device=i.device))

    return apply("shard_index", fn, as_tensor(input))


# ---------------------------------------------------------------------------
# __getitem__ / __setitem__
# ---------------------------------------------------------------------------
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
        if isinstance(i, builtins.slice):
            return builtins.slice(*(int(v.item()) if isinstance(v, Tensor)
                                    else v for v in (i.start, i.stop,
                                                     i.step)))
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
            dim = len(shape) - builtins.sum(
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


def setitem(x, item, value):
    """``x[item] = value``: computed out of place (gradients reach both
    ``x``'s old value and ``value``), then ``x`` is rebound."""
    x = as_tensor(x)
    idx = _normalize_index(item, x._data.device)
    _check_int_bounds(idx, x.shape)

    def put(a, v):
        out = a.clone()
        out[idx] = v
        return out

    if isinstance(value, Tensor):
        out = apply("setitem", lambda a, v: put(a, v.to(a.dtype)), x, value)
    else:
        out = apply("setitem", lambda a: put(a, value), x)
    return x._inplace_assign(out)


def pad_sequences(seqs, pad_value=0):
    maxlen = builtins.max(len(s) for s in seqs)
    out = np.full((len(seqs), maxlen), pad_value)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = np.asarray(s)
    return as_tensor(out)
