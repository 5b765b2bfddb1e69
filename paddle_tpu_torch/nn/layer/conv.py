"""``Conv1D`` / ``2D`` / ``3D`` and ``Conv1DTranspose`` / ``2D`` / ``3D``
(counterpart of ``paddle_tpu/nn/layer/conv.py``).  The weight is ``[out,
in / groups, *kernel]`` (``[in, out / groups, *kernel]`` for a transpose),
Xavier-uniform by default, and the bias U(-1 / sqrt(fan_in), 1 /
sqrt(fan_in)) with ``fan_in = in * prod(kernel) / groups``, JAX's
initializers; a JAX ``state_dict()`` loads unchanged."""

from __future__ import annotations

import numpy as np

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _ntuple(v, n):
    if isinstance(v, (int, np.integer)):
        return [int(v)] * n
    return [int(i) for i in v]


class _ConvNd(Layer):
    _FN = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
    _FN_T = {1: F.conv1d_transpose, 2: F.conv2d_transpose,
             3: F.conv3d_transpose}

    def __init__(self, nd, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, transpose=False, output_padding=0):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode={padding_mode!r}: only 'zeros' is ported")
        self._nd = nd
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, nd)
        self._stride = _ntuple(stride, nd)
        self._padding = padding
        self._dilation = _ntuple(dilation, nd)
        self._groups = groups
        self._data_format = data_format
        self._transpose = transpose
        self._output_padding = output_padding
        w_shape = [in_channels, out_channels // groups] if transpose else \
            [out_channels, in_channels // groups]
        fan_in = in_channels * int(np.prod(self._kernel_size)) // groups
        bound = 1.0 / np.sqrt(fan_in)
        self.weight = self.create_parameter(
            w_shape + self._kernel_size, attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound)
            if bias_attr is None else None)

    def forward(self, x):
        if self._transpose:
            return self._FN_T[self._nd](
                x, self.weight, self.bias, stride=self._stride,
                padding=self._padding, output_padding=self._output_padding,
                groups=self._groups, dilation=self._dilation,
                data_format=self._data_format)
        return self._FN[self._nd](
            x, self.weight, self.bias, stride=self._stride,
            padding=self._padding, dilation=self._dilation,
            groups=self._groups, data_format=self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)
