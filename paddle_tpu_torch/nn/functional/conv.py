"""Convolutions: ``conv1d``, ``conv2d``, ``conv3d`` and their transposes.

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
matter.

``conv{1,2,3}d_transpose`` take the weight ``[in, out / groups, *kernel]``
(Paddle's layout, and torch's).  JAX computes them as the convolution of
the stride-dilated input with the flipped kernel, padded ``(k - 1) * d -
p_lo`` and ``(k - 1) * d - p_hi + output_padding`` (or XLA's "SAME" /
"VALID" rule over the dilated input); here that is cuDNN's transposed
convolution with torch's padding where the two agree (even padding,
``output_padding`` below the stride or the dilation), else the
transposed convolution without padding cropped (or extended by zero
rows) to the same window.  ``output_size`` is taken and not read, as in
JAX.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as TF

from ...ops.dispatch import apply, as_tensor

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

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
    """``torch.convolution`` (transposed or not) whose forward and
    backward both run under :data:`F32_CONV_ALLOW_TF32` (autograd would run
    the backward under the global setting of the moment)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, groups,
                transposed=False, out_pad=None):
        ctx.save_for_backward(x, w)
        out_pad = out_pad or [0] * len(stride)
        ctx.conf = (stride, padding, dilation, groups, b is not None,
                    transposed, out_pad)
        with _cudnn_tf32(F32_CONV_ALLOW_TF32):
            return torch.convolution(x, w, b, stride, padding, dilation,
                                     transposed, out_pad, groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups, has_b, transposed, out_pad = \
            ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                has_b and ctx.needs_input_grad[2]]
        n_out = w.shape[1] * groups if transposed else w.shape[0]
        with _cudnn_tf32(F32_CONV_ALLOW_TF32):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                gy, x, w, [n_out] if has_b else None, list(stride),
                list(padding), list(dilation), transposed, list(out_pad),
                groups, mask)
        return gx, gw, gb, None, None, None, None, None, None


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


def _transpose_window(padding, nd, kernel, stride, dilation, out_pad):
    """The transposed convolution's padding -> (crop_lo, crop_hi) a
    spatial axis of the unpadded transposed convolution's output
    (negative: zero rows added).  Explicit padding is JAX's; the strings,
    which JAX's lax call refuses, are Paddle's: "SAME" gives ``in *
    stride`` outputs (``max(k_eff - stride, 0)`` cropped, the odd one on
    the high side), "VALID" crops nothing."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding}")
        out = []
        for d in range(nd):
            eff = (kernel[d] - 1) * dilation[d] + 1
            total = max(eff - stride[d], 0) if mode == "SAME" else 0
            out.append((total // 2, total - total // 2))
        return out
    pads = _pads(padding, nd, None, kernel, stride, dilation)
    return [(lo, hi - out_pad[d]) for d, (lo, hi) in enumerate(pads)]


def _conv_transpose_nd(name, x, weight, bias, stride, padding,
                       output_padding, groups, dilation, nd, data_format):
    x, weight = as_tensor(x), as_tensor(weight)
    stride = _norm_tuple(stride, nd)
    dilation = _norm_tuple(dilation, nd)
    opad = _norm_tuple(output_padding, nd)
    channel_last = data_format.endswith("C")
    crops = _transpose_window(padding, nd, weight.shape[2:], stride,
                              dilation, opad)
    native = all(lo == hi + opad[d] and lo >= 0 and
                 opad[d] < max(stride[d], dilation[d])
                 for d, (lo, hi) in enumerate(crops))

    def fn(a, w, *b):
        if channel_last:
            a = a.movedim(-1, 1)
        if native:
            out = _Conv.apply(a, w, b[0] if b else None, list(stride),
                              [lo for lo, _ in crops], list(dilation),
                              groups, True, list(opad))
        else:
            out = _Conv.apply(a, w, None, list(stride), [0] * nd,
                              list(dilation), groups, True, [0] * nd)
            # F.pad with negative amounts crops
            out = TF.pad(out, [-v for lo, hi in reversed(crops)
                               for v in (lo, hi)])
            if b:
                out = out + b[0].reshape((1, -1) + (1,) * nd)
        return out.movedim(1, -1) if channel_last else out

    if bias is not None:
        return apply(name, fn, x, weight, as_tensor(bias))
    return apply(name, fn, x, weight)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose_nd("conv1d_transpose", x, weight, bias, stride,
                              padding, output_padding, groups, dilation, 1,
                              data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose_nd("conv2d_transpose", x, weight, bias, stride,
                              padding, output_padding, groups, dilation, 2,
                              data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_nd("conv3d_transpose", x, weight, bias, stride,
                              padding, output_padding, groups, dilation, 3,
                              data_format)
