"""Pooling layers (counterpart of ``paddle_tpu/nn/layer/pooling.py``):
``MaxPool1D`` / ``2D`` / ``3D``, ``AvgPool1D`` / ``2D`` / ``3D`` and
``AdaptiveAvgPool1D`` / ``2D`` / ``3D`` and ``AdaptiveMaxPool1D`` /
``2D``, each over its functional op (``nn/functional/pooling.py``;
``AdaptiveMaxPool3D`` is in ``extras.py``, as in JAX)."""

from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D"]


class _Pool(Layer):
    def __init__(self, fn_name, kernel_size, stride=None, padding=0,
                 **kwargs):
        super().__init__()
        self._fn_name = fn_name
        self._kernel_size = kernel_size
        self._stride = stride
        self._padding = padding
        self._kwargs = kwargs

    def forward(self, x):
        return getattr(F, self._fn_name)(
            x, self._kernel_size, stride=self._stride,
            padding=self._padding, **self._kwargs)

    def extra_repr(self):
        return (f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__("max_pool1d", kernel_size, stride, padding,
                         return_mask=return_mask, ceil_mode=ceil_mode)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__("max_pool2d", kernel_size, stride, padding,
                         return_mask=return_mask, ceil_mode=ceil_mode)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__("max_pool3d", kernel_size, stride, padding,
                         return_mask=return_mask, ceil_mode=ceil_mode)


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__("avg_pool1d", kernel_size, stride, padding,
                         exclusive=exclusive, ceil_mode=ceil_mode)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__("avg_pool2d", kernel_size, stride, padding,
                         exclusive=exclusive, ceil_mode=ceil_mode)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None,
                 data_format="NCDHW", name=None):
        super().__init__("avg_pool3d", kernel_size, stride, padding,
                         exclusive=exclusive, ceil_mode=ceil_mode)


class _AdaptivePool(Layer):
    def __init__(self, fn_name, output_size, **kwargs):
        super().__init__()
        self._fn_name = fn_name
        self._output_size = output_size
        self._kwargs = kwargs

    def forward(self, x):
        return getattr(F, self._fn_name)(x, self._output_size,
                                         **self._kwargs)

    def extra_repr(self):
        return f"output_size={self._output_size}"


class AdaptiveAvgPool1D(_AdaptivePool):
    def __init__(self, output_size, name=None):
        super().__init__("adaptive_avg_pool1d", output_size)


class AdaptiveAvgPool2D(_AdaptivePool):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__("adaptive_avg_pool2d", output_size)


class AdaptiveAvgPool3D(_AdaptivePool):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__("adaptive_avg_pool3d", output_size)


class AdaptiveMaxPool1D(_AdaptivePool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__("adaptive_max_pool1d", output_size,
                         return_mask=return_mask)


class AdaptiveMaxPool2D(_AdaptivePool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__("adaptive_max_pool2d", output_size,
                         return_mask=return_mask)
