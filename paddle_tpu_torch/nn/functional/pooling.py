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
n)``).  JAX has no Pallas kernel here.  ``return_mask`` and the adaptive
max pools are not ported yet (ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...ops.dispatch import apply, as_tensor
from .conv import _norm_tuple

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d"]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADAPTIVE = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d,
             3: TF.adaptive_avg_pool3d}


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


def _no_mask(return_mask):
    if return_mask:
        raise NotImplementedError(
            "max pooling's return_mask is not ported yet (ROADMAP.md queue "
            "1 item 10)")


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    _no_mask(return_mask)
    return _pool_nd("max_pool1d", x, kernel_size, stride, padding, 1, False,
                    ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    _no_mask(return_mask)
    return _pool_nd("max_pool2d", x, kernel_size, stride, padding, 2, False,
                    ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    _no_mask(return_mask)
    return _pool_nd("max_pool3d", x, kernel_size, stride, padding, 3, False,
                    ceil_mode)


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
