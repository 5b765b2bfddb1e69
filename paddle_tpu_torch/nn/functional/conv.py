"""Convolutions: ``conv1d``, ``conv2d`` and ``conv3d``.

Counterpart of ``_conv_nd`` in ``paddle_tpu/nn/functional/__init__.py``.
The weight keeps Paddle's ``[out, in / groups, *kernel]`` layout, which is
torch's, so a JAX ``state_dict()`` loads unchanged.  ``padding`` is JAX's:
an int or one int a spatial axis (both sides), ``2 * nd`` ints (a ``(lo,
hi)`` pair an axis), or the strings ``"SAME"`` / ``"VALID"`` (XLA's rule:
``ceil(in / stride)`` outputs, the odd cell of the padding on the high
side).  Uneven padding is a zero pad of the input before the convolution.
JAX has no Pallas kernel for a convolution: the op is cuDNN's on the card
(torch's own convolution on the CPU), under the op name ``conv<n>d`` so
that AMP's white list reaches it.

The precision of an f32 convolution is decided here, in one place:
:data:`F32_CONV_ALLOW_TF32` (False: f32 convolutions compute in f32, as
torch's matmuls do by default, not in cuDNN's default TF32).  The forward
and both gradients run under it, whatever ``torch.backends.cudnn`` says
outside.  Under AMP O1 the convolutions run in bf16 and the flag does not
matter.  The transposed convolutions are not ported yet (ROADMAP.md queue
1 item 10).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as TF

from ...ops.dispatch import apply, as_tensor

__all__ = ["conv1d", "conv2d", "conv3d"]

F32_CONV_ALLOW_TF32 = False


def _norm_tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(i) for i in v)


@contextlib.contextmanager
def _cudnn_tf32(allow: bool):
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Conv(torch.autograd.Function):
    """``torch.convolution`` whose forward and backward both run under
    :data:`F32_CONV_ALLOW_TF32` (autograd would run the backward under the
    global setting of the moment)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups, b is not None)
        with _cudnn_tf32(F32_CONV_ALLOW_TF32):
            return torch.convolution(x, w, b, stride, padding, dilation,
                                     False, [0] * len(stride), groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups, has_b = ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                has_b and ctx.needs_input_grad[2]]
        with _cudnn_tf32(F32_CONV_ALLOW_TF32):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                gy, x, w, [w.shape[0]] if has_b else None, list(stride),
                list(padding), list(dilation), False, [0] * len(stride),
                groups, mask)
        return gx, gw, gb, None, None, None, None


def _pads(padding, nd, in_sizes, kernel, stride, dilation):
    """JAX's padding argument -> one ``(lo, hi)`` pair a spatial axis."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * nd
        if mode != "SAME":
            raise ValueError(f"padding must be SAME or VALID, got {padding}")
        out = []
        for d in range(nd):
            eff = (kernel[d] - 1) * dilation[d] + 1
            n_out = -(-in_sizes[d] // stride[d])
            total = max((n_out - 1) * stride[d] + eff - in_sizes[d], 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * nd:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(nd)]
    return [(p, p) for p in _norm_tuple(padding, nd)]


def _conv_nd(name, x, weight, bias, stride, padding, dilation, groups, nd,
             data_format):
    x, weight = as_tensor(x), as_tensor(weight)
    stride = _norm_tuple(stride, nd)
    dilation = _norm_tuple(dilation, nd)
    channel_last = data_format.endswith("C")
    sp = x.shape[1:1 + nd] if channel_last else x.shape[2:]
    pads = _pads(padding, nd, sp, weight.shape[2:], stride, dilation)
    even = all(lo == hi for lo, hi in pads)

    def fn(a, w, *b):
        if channel_last:
            a = a.movedim(-1, 1)
        if not even:
            a = TF.pad(a, [v for lo, hi in reversed(pads) for v in (lo, hi)])
        sym = [lo if even else 0 for lo, _ in pads]
        out = _Conv.apply(a, w, b[0] if b else None, list(stride), sym,
                          list(dilation), groups)
        return out.movedim(1, -1) if channel_last else out

    if bias is not None:
        return apply(name, fn, x, weight, as_tensor(bias))
    return apply(name, fn, x, weight)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd("conv1d", x, weight, bias, stride, padding, dilation,
                    groups, 1, data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd("conv2d", x, weight, bias, stride, padding, dilation,
                    groups, 2, data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd("conv3d", x, weight, bias, stride, padding, dilation,
                    groups, 3, data_format)
