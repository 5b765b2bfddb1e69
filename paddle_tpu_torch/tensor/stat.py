"""Statistics (counterpart of ``paddle_tpu/tensor/stat.py``).

``median`` / ``nanmedian`` default to ``mode="avg"``, the mean of the two
middle values of an even count (``torch.median`` returns the lower one);
``mode="min"`` gives the lower one.  ``quantile`` / ``nanquantile`` take
JAX's ``interpolation`` names.  ``var`` / ``std`` divide by n - 1 when
``unbiased``.  ``histogram`` counts are int64 (float with ``density``),
``bincount`` int64 (float64 with weights), ``histogramdd`` float64 with
its edges in the input's type, as JAX's numpy path gives.
"""

from __future__ import annotations

import torch

from ..ops.dispatch import apply, as_tensor
from .creation import numel  # noqa: F401
from .math import _dims, _inexact, _normalize_axis, mean  # noqa: F401
from .tensor import Tensor, wrap_array

__all__ = ["mean", "std", "var", "median", "nanmedian", "quantile",
           "nanquantile", "histogram", "histogramdd", "bincount", "numel"]


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _normalize_axis(axis)
    return apply("std", lambda a: torch.std(
        _inexact(a), dim=_dims(ax, a.dim()), correction=int(unbiased),
        keepdim=keepdim), as_tensor(x))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _normalize_axis(axis)
    return apply("var", lambda a: torch.var(
        _inexact(a), dim=_dims(ax, a.dim()), correction=int(unbiased),
        keepdim=keepdim), as_tensor(x))


def _over_axis(a, ax, keepdim, fn, lead=()):
    """``fn(rows)`` over the last axis of ``a`` permuted so that ``ax`` (or
    every axis) comes last; ``fn``'s result has ``lead`` axes first, then
    the rest of ``a``'s (kept as size 1 with ``keepdim``)."""
    if ax is None:
        out = fn(a.reshape(-1))
        return out.reshape(lead + (1,) * a.dim()) if keepdim else out
    dims = tuple(d % a.dim() for d in _dims(ax, a.dim()))
    rest = [d for d in range(a.dim()) if d not in dims]
    moved = a.permute(rest + list(dims))
    out = fn(moved.reshape(moved.shape[:len(rest)] + (-1,)))
    if keepdim:
        shape = list(a.shape)
        for d in dims:
            shape[d] = 1
        out = out.reshape(lead + tuple(shape))
    return out


def _middle(rows, avg, nan):
    """The median of each row of ``rows`` (NaN rows give NaN unless
    ``nan``, which skips NaNs)."""
    rows = _inexact(rows)
    s = torch.sort(rows, dim=-1).values      # NaNs sort last
    if nan:
        n = (~torch.isnan(rows)).sum(-1, keepdim=True)
    else:
        n = torch.full(rows.shape[:-1] + (1,), rows.shape[-1],
                       device=rows.device)
    lo = ((n - 1).clamp(min=0) // 2)
    hi = n // 2 if avg else lo
    hi = torch.where(n > 0, hi, lo)
    out = (s.gather(-1, lo) + s.gather(-1, hi)) / 2 if avg else \
        s.gather(-1, lo)
    out = out[..., 0]
    if not nan:
        out = torch.where(torch.isnan(rows).any(-1),
                          torch.full((), float("nan"), dtype=out.dtype,
                                     device=out.device), out)
    else:
        out = torch.where(n[..., 0] > 0, out, torch.full(
            (), float("nan"), dtype=out.dtype, device=out.device))
    return out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    ax = _normalize_axis(axis)
    if mode == "avg":
        return apply("median", lambda a: _over_axis(
            a, ax, keepdim, lambda r: _middle(r, True, False)), as_tensor(x))
    return apply("median", lambda a: _over_axis(
        a, ax, keepdim, lambda r: torch.sort(r, dim=-1).values[
            ..., (r.shape[-1] - 1) // 2]), as_tensor(x))


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    ax = _normalize_axis(axis)
    return apply("nanmedian", lambda a: _over_axis(
        a, ax, keepdim, lambda r: _middle(r, True, True)), as_tensor(x))


_METHODS = ("linear", "lower", "higher", "midpoint", "nearest")


def _quantile_rows(rows, qv, method, nan):
    """JAX's ``_quantile`` over the last axis of ``rows``: positions
    q * (n - 1) (n the count of non-NaNs when ``nan``), the two sorted
    neighbours and their weights in float64 (JAX's q is a float64 array),
    the result in ``rows``' type, with q's axis first."""
    q = torch.as_tensor(qv, dtype=torch.float64, device=rows.device)
    if nan:
        s = torch.sort(rows, dim=-1).values            # NaNs sort last
        counts = (~torch.isnan(s)).sum(-1, keepdim=True).to(torch.float64)
    else:
        s = torch.sort(torch.where(torch.isnan(rows).any(-1, keepdim=True),
                                   torch.full((), float("nan"),
                                              dtype=rows.dtype,
                                              device=rows.device), rows),
                       dim=-1).values
        counts = torch.full(rows.shape[:-1] + (1,), rows.shape[-1],
                            dtype=torch.float64, device=rows.device)
    qe = q.reshape(q.shape + (1,) * rows.dim())        # [Q, 1.., 1]
    pos = qe * (counts - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    top = counts - 1
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, top))
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, top))
    lead = q.shape + s.shape[:-1] + (1,)
    sx = s.expand(q.shape + s.shape)
    lv = torch.gather(sx, -1, low.long().expand(lead))[..., 0]
    hv = torch.gather(sx, -1, high.long().expand(lead))[..., 0]
    lw, hw = lw[..., 0], hw[..., 0]
    if method == "linear":
        out = lv.double() * lw + hv.double() * hw
    elif method == "lower":
        out = lv
    elif method == "higher":
        out = hv
    elif method == "nearest":
        out = torch.where(hw <= 0.5, lv, hv)
    else:
        out = (lv + hv) * 0.5
    return out.to(rows.dtype)


def _quantile(x, q, axis, keepdim, interpolation, name, nan):
    if interpolation not in _METHODS:
        raise ValueError(f"interpolation must be one of {_METHODS}")
    ax = _normalize_axis(axis)
    qv = q.tolist() if isinstance(q, Tensor) else q
    lead = (len(qv),) if isinstance(qv, (list, tuple)) else ()

    def fn(a):
        return _over_axis(_inexact(a), ax, keepdim, lambda r: _quantile_rows(
            r, qv, interpolation, nan), lead)

    return apply(name, fn, as_tensor(x))


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(x, q, axis, keepdim, interpolation, "quantile", False)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return _quantile(x, q, axis, keepdim, interpolation, "nanquantile",
                     True)


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    """Counts of ``bins`` equal bins over [min, max] (the data's own range
    when both are 0); int64, or float with ``density``."""
    input = as_tensor(input)
    lo, hi = float(min), float(max)

    def fn(a, *w):
        a = a.reshape(-1)
        if lo == 0 and hi == 0:
            mn, mx = a.min(), a.max()
        else:
            mn = torch.full((), lo, dtype=a.dtype, device=a.device)
            mx = torch.full((), hi, dtype=a.dtype, device=a.device)
        same = mx == mn
        mn, mx = torch.where(same, mn - 0.5, mn), torch.where(same, mx + 0.5,
                                                              mx)
        # numpy's edges and rule: the last bin is closed, values outside
        # the range are dropped
        step = (mx - mn) / bins
        edges = mn + torch.arange(bins + 1, device=a.device,
                                  dtype=a.dtype) * step
        edges[-1] = mx
        idx = torch.searchsorted(edges, a.contiguous(), right=True) - 1
        idx = torch.where(a == mx, bins - 1, idx)
        keep = (idx >= 0) & (idx < bins)
        wt = w[0].reshape(-1) if w else torch.ones_like(a)
        hist = torch.zeros(bins, dtype=wt.dtype, device=a.device).index_add(
            0, idx.clamp(0, bins - 1), torch.where(keep, wt,
                                                   torch.zeros_like(wt)))
        if density:
            return hist / (edges[1:] - edges[:-1]) / hist.sum()
        return hist if w else hist.to(torch.int64)

    if weight is not None:
        return apply("histogram", fn, input, as_tensor(weight))
    return apply("histogram", fn, input)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """The d-dimensional histogram of the rows of ``x`` [N, d] and the bin
    edges of each dimension (float64, as JAX's numpy path)."""
    src = as_tensor(x)._data.detach()
    a = src.double()
    w = as_tensor(weights)._data.detach().double() \
        if weights is not None else None
    d = a.shape[-1]
    if isinstance(bins, (list, tuple)) and bins and isinstance(
            bins[0], Tensor):
        bins = [b._data.detach().double().to(a.device) for b in bins]
    r = None
    if ranges is not None:
        r = [float(v) for v in ranges]
    hist, edges = torch.histogramdd(
        a.reshape(-1, d).cpu(),
        bins=[b.cpu() for b in bins] if isinstance(bins, list) and bins and
        isinstance(bins[0], torch.Tensor) else bins,
        range=r, weight=None if w is None else w.reshape(-1).cpu(),
        density=density)
    dev = a.device
    edge_t = src.dtype if src.is_floating_point() else torch.float64
    return (wrap_array(hist.to(dev)),
            [wrap_array(e.to(device=dev, dtype=edge_t)) for e in edges])


def bincount(x, weights=None, minlength=0, name=None):
    a = as_tensor(x)._data.detach()
    w = as_tensor(weights)._data.detach() if weights is not None else None
    out = torch.bincount(a.reshape(-1), weights=None if w is None else
                         w.reshape(-1).double(), minlength=minlength)
    return wrap_array(out if w is not None else out.to(torch.int64))
