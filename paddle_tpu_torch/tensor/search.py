"""Sorts and searches (counterpart of ``paddle_tpu/tensor/search.py``).

Indices are int64 (int32 with ``out_int32``), as JAX's.  Sorts are stable
whatever ``stable`` says, as JAX's are, so ties keep their order on the
card too; ``kthvalue`` is 1-based, and ``mode`` gives the largest of the
most frequent values and its last index.  ``top_p_sampling`` draws from
the framework's generator of the logits' device (or one seeded with
``seed``): it matches JAX's in distribution, not bit for bit.
"""

from __future__ import annotations

import torch

from ..framework import dtype as dtypes
from ..framework import random as framework_random
from ..ops.dispatch import apply, as_tensor
from .tensor import Tensor, wrap_array

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "nonzero",
           "kthvalue", "mode", "searchsorted", "bucketize", "index_select",
           "masked_select", "top_p_sampling"]


def _arg(name, tfn):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        tdt = dtypes.to_torch_dtype(dtype)
        if axis is None:
            return apply(op.__name__, lambda a: tfn(a.reshape(-1)).to(tdt),
                         as_tensor(x))
        return apply(op.__name__, lambda a: tfn(
            a, dim=int(axis), keepdim=keepdim).to(tdt), as_tensor(x))
    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"The first {name[3:]}imal index (along ``axis``, or of " \
                 "the flattened tensor)."
    return op


argmax = _arg("argmax", torch.argmax)
argmin = _arg("argmin", torch.argmin)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    ax = int(axis)
    return apply("argsort", lambda a: torch.sort(
        a, dim=ax, descending=descending, stable=True).indices.to(
            torch.int64), as_tensor(x))


def sort(x, axis=-1, descending=False, stable=False, name=None):
    ax = int(axis)
    return apply("sort", lambda a: torch.sort(
        a, dim=ax, descending=descending, stable=True).values, as_tensor(x))


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """(values, int64 indices) of the ``k`` largest (or smallest) along
    ``axis`` (the last by default)."""
    k = int(k.item()) if isinstance(k, Tensor) else int(k)
    ax = -1 if axis is None else int(axis)

    def fn(a):
        vals, idx = torch.topk(a, k, dim=ax, largest=largest, sorted=True)
        return vals, idx.to(torch.int64)

    return apply("topk", fn, as_tensor(x))


def nonzero(x, as_tuple=False):
    """The indices of the nonzero elements, int64 (a host-sized result)."""
    idx = torch.nonzero(as_tensor(x)._data.detach())
    if as_tuple:
        return tuple(wrap_array(idx[:, i].contiguous())
                     for i in range(idx.shape[1]))
    return wrap_array(idx.to(torch.int64))


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The ``k``-th smallest (1-based) along ``axis`` and its index in a
    stable sort."""
    ax = int(axis)

    def fn(a):
        s, si = torch.sort(a, dim=ax, stable=True)
        vals = s.select(ax, k - 1)
        idx = si.select(ax, k - 1).to(torch.int64)
        if keepdim:
            vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
        return vals, idx

    return apply("kthvalue", fn, as_tensor(x))


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the largest of a tie) and
    the index of its last occurrence."""
    x = as_tensor(x)
    a = x._data.detach()
    ax = int(axis) % a.dim()
    rows = a.movedim(ax, -1)
    shape = rows.shape[:-1]
    flat = rows.reshape(-1, rows.shape[-1])
    n = flat.shape[-1]
    s, _ = torch.sort(flat, dim=-1, stable=True)
    # run lengths over the sorted rows: a value's count is the span of its
    # run; the last of the longest runs holds the largest mode
    start = torch.ones_like(s, dtype=torch.bool)
    start[:, 1:] = s[:, 1:] != s[:, :-1]
    pos = torch.arange(n, device=a.device).expand_as(s)
    run_start = torch.cummax(torch.where(start, pos, 0), dim=-1).values
    count = pos - run_start + 1
    best = count.max(dim=-1, keepdim=True).values
    last_best = torch.where(count == best, pos, -1).max(dim=-1).indices
    vals = s.gather(-1, last_best[:, None])[:, 0]
    hit = flat == vals[:, None]
    idx = torch.where(hit, pos, -1).max(dim=-1).values.to(torch.int64)
    vals, idx = vals.reshape(shape), idx.reshape(shape)
    if keepdim:
        vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
    return wrap_array(vals), wrap_array(idx)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    dt = torch.int32 if out_int32 else torch.int64
    return apply("searchsorted", lambda seq, v: torch.searchsorted(
        seq.contiguous(), v.contiguous(), right=right).to(dt),
        as_tensor(sorted_sequence), as_tensor(values))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    dt = torch.int32 if out_int32 else torch.int64
    return apply("bucketize", lambda a, seq: torch.searchsorted(
        seq.contiguous(), a.contiguous(), right=right).to(dt),
        as_tensor(x), as_tensor(sorted_sequence))


def top_p_sampling(x, ps, threshold=None, seed=None, name=None):
    """Nucleus sampling over the last axis of logits ``x`` with the
    per-row mass ``ps``: (the kept probability of each pick, its int64
    index), each ``[..., 1]``."""
    x, ps = as_tensor(x), as_tensor(ps)
    dev = x._data.device
    gen = framework_random.generator(dev) if seed is None else \
        torch.Generator(device=dev).manual_seed(int(seed))

    def fn(logits, p):
        probs = torch.softmax(logits, dim=-1)
        sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True,
                                              stable=True)
        cum = torch.cumsum(sorted_probs, dim=-1)
        keep = cum - sorted_probs <= p[..., None].to(cum.dtype)
        filt = torch.where(keep, sorted_probs, torch.zeros_like(sorted_probs))
        filt = filt / filt.sum(-1, keepdim=True)
        flat = filt.reshape(-1, filt.shape[-1]).float()
        choice = torch.multinomial(flat, 1, generator=gen).reshape(
            filt.shape[:-1] + (1,))
        ids = torch.gather(sorted_idx, -1, choice)
        return torch.gather(filt, -1, choice), ids.to(torch.int64)

    return apply("top_p_sampling", fn, x, ps)


from .manipulation import index_select, masked_select  # noqa: E402,F401
