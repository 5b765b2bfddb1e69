"""Pooling: ``max_pool{1,2,3}d``, ``avg_pool{1,2,3}d`` and
``adaptive_avg_pool{1,2,3}d``.

Counterpart of ``_pool_nd`` and ``_adaptive_pool`` in
``paddle_tpu/nn/functional/__init__.py``, whose rules these keep:

* ``ceil_mode`` adds the last partial window, ``ceil((L + 2p - k) / s) +
  1`` outputs, but drops a window that would start inside the right
  padding;
* an average divides by the cells of its window that lie in the input
  (``exclusive=True``) or in the input and the explicit padding
  (``exclusive=False``); the cells that ``ceil_mode`` adds never count.

Torch's pooling has the same two rules, so where it takes the padding
(``2 * p <= k`` on every axis) the op is torch's (cuDNN's or ATen's kernel
on the card).  Otherwise the rule is written out: the input padded by hand
(-inf for a max, 0 for an average), pooled without padding, and an average
divided by the count of its counted cells.  The adaptive average takes
torch's bins, which are JAX's (``floor(i * L / n)`` to ``ceil((i + 1) * L /
n)``).  JAX has no Pallas kernel here.

``return_mask=True`` gives each maximum's flat index in its sample's
unpadded spatial plane (``h * W + w``), int32, with the value: torch's
``return_indices`` where torch takes the padding, else the written-out
pool's argmax translated back from the padded plane (JAX's
``max_pool2d_with_index``, the first maximum of a window on a tie).  JAX
gives that mask for the 2-D pool alone and ``None`` for the 1-D and 3-D
pools and the adaptive ones (its 3-D adaptive pool raises); the port
gives the mask for all of them, the input ``max_unpool*`` takes.  The
adaptive max pools are torch's (the adaptive average's bins).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...ops.dispatch import apply, as_tensor
from .conv import _norm_tuple

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADAPTIVE = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d,
             3: TF.adaptive_avg_pool3d}
_ADAPTIVE_MAX = {1: TF.adaptive_max_pool1d, 2: TF.adaptive_max_pool2d,
                 3: TF.adaptive_max_pool3d}


def _ceil_extra(L, k, s, p):
    """The cells ``ceil_mode`` pads past the right padding (JAX's rule)."""
    n = -(-(L + 2 * p - k) // s) + 1
    if (n - 1) * s >= L + p:
        n -= 1
    return max(0, (n - 1) * s + k - (L + 2 * p))


def _flat_pads(pairs):
    """(lo, hi) pairs, first axis first -> ``F.pad``'s list."""
    return [v for lo, hi in reversed(pairs) for v in (lo, hi)]


def _pool_written_out(a, kernel, stride, p, nd, average, ceil_mode,
                      exclusive):
    spatial = a.shape[2:]
    extra = [_ceil_extra(spatial[d], kernel[d], stride[d], p[d])
             if ceil_mode else 0 for d in range(nd)]
    pads = [(p[d], p[d] + extra[d]) for d in range(nd)]
    fill = 0.0 if average else -math.inf
    padded = TF.pad(a, _flat_pads(pads), value=fill)
    if not average:
        return _MAX[nd](padded, kernel, stride)
    sums = _AVG[nd](padded, kernel, stride) * math.prod(kernel)
    ones = torch.ones((1, 1) + tuple(spatial), dtype=a.dtype,
                      device=a.device)
    if exclusive:
        counted = TF.pad(ones, _flat_pads(pads))
    else:
        counted = TF.pad(TF.pad(ones, _flat_pads([(q, q) for q in p]),
                                value=1.0),
                         _flat_pads([(0, e) for e in extra]))
    counts = _AVG[nd](counted, kernel, stride) * math.prod(kernel)
    return sums / counts


def _pool_nd(name, x, kernel, stride, padding, nd, average, ceil_mode=False,
             exclusive=True):
    x = as_tensor(x)
    kernel = _norm_tuple(kernel, nd)
    stride = _norm_tuple(stride if stride is not None else kernel, nd)
    p = _norm_tuple(padding, nd)
    native = all(2 * p[d] <= kernel[d] for d in range(nd))

    def fn(a):
        if not native:
            return _pool_written_out(a, kernel, stride, p, nd, average,
                                     ceil_mode, exclusive)
        if average:
            return _AVG[nd](a, kernel, stride, p, ceil_mode=ceil_mode,
                            count_include_pad=not exclusive)
        return _MAX[nd](a, kernel, stride, p, ceil_mode=ceil_mode)

    return apply(name, fn, x)


def _max_with_mask(a, kernel, stride, p, nd, ceil_mode):
    """(max, flat index in the unpadded plane) of a max pool."""
    if all(2 * p[d] <= kernel[d] for d in range(nd)):
        out, idx = _MAX[nd](a, kernel, stride, p, ceil_mode=ceil_mode,
                            return_indices=True)
        return out, idx.to(torch.int32)
    if ceil_mode:
        raise ValueError("return_mask with ceil_mode takes padding of at "
                         "most half the kernel")
    padded = TF.pad(a, _flat_pads([(q, q) for q in p]), value=-math.inf)
    out, idx = _MAX[nd](padded, kernel, stride, return_indices=True)
    sp = a.shape[2:]
    psp = padded.shape[2:]
    flat = torch.zeros_like(idx)
    rest = idx
    for d in reversed(range(nd)):
        coord = rest % psp[d] - p[d]
        rest = rest // psp[d]
        flat = flat + coord * math.prod(sp[d + 1:])
    return out, flat.to(torch.int32)


def _max_pool(name, x, kernel_size, stride, padding, nd, ceil_mode,
              return_mask):
    if not return_mask:
        return _pool_nd(name, x, kernel_size, stride, padding, nd, False,
                        ceil_mode)
    x = as_tensor(x)
    kernel = _norm_tuple(kernel_size, nd)
    stride = _norm_tuple(stride if stride is not None else kernel, nd)
    p = _norm_tuple(padding, nd)
    return apply(name, lambda a: _max_with_mask(a, kernel, stride, p, nd,
                                                ceil_mode), x)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _max_pool("max_pool1d", x, kernel_size, stride, padding, 1,
                     ceil_mode, return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    return _max_pool("max_pool2d", x, kernel_size, stride, padding, 2,
                     ceil_mode, return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    return _max_pool("max_pool3d", x, kernel_size, stride, padding, 3,
                     ceil_mode, return_mask)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool_nd("avg_pool1d", x, kernel_size, stride, padding, 1, True,
                    ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool_nd("avg_pool2d", x, kernel_size, stride, padding, 2, True,
                    ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool_nd("avg_pool3d", x, kernel_size, stride, padding, 3, True,
                    ceil_mode, exclusive)


def _adaptive_pool(name, x, output_size, nd):
    x = as_tensor(x)
    sizes = list(_norm_tuple(output_size, nd))
    return apply(name, lambda a: _ADAPTIVE[nd](a, sizes), x)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool("adaptive_avg_pool1d", x, output_size, 1)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool("adaptive_avg_pool2d", x, output_size, 2)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool("adaptive_avg_pool3d", x, output_size, 3)


def _adaptive_max(name, x, output_size, nd, return_mask):
    x = as_tensor(x)
    sizes = list(_norm_tuple(output_size, nd))

    def fn(a):
        out, idx = _ADAPTIVE_MAX[nd](a, sizes, return_indices=True)
        return (out, idx.to(torch.int32)) if return_mask else out

    return apply(name, fn, x)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_max("adaptive_max_pool1d", x, output_size, 1,
                         return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_max("adaptive_max_pool2d", x, output_size, 2,
                         return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_max("adaptive_max_pool3d", x, output_size, 3,
                         return_mask)
