"""Normalisation layers (counterpart of ``paddle_tpu/nn/layer/norm.py``):
``BatchNorm`` / ``BatchNorm1D`` / ``2D`` / ``3D``, ``SyncBatchNorm``,
``LayerNorm``, ``RMSNorm``, ``InstanceNorm1D`` / ``2D`` / ``3D``,
``GroupNorm``, ``LocalResponseNorm`` and ``SpectralNorm``.  The batch
norms keep JAX's buffers, ``_mean`` (zeros) and ``_variance`` (ones), under
JAX's names, so a JAX ``state_dict()`` loads; ``F.batch_norm`` rebinds
them in training (Paddle's ``momentum``: the old statistic's share).
``SyncBatchNorm`` in one process is ``BatchNorm``, as in JAX; across
processes its forward raises (ROADMAP.md queue 1 item 9(a)).  ``RMSNorm``
goes through ``F.rms_norm``, so the K9a / K9b kernels on the card;
``LayerNorm`` through ``F.layer_norm`` (JAX has no kernel for it).
``weight_attr=False`` / ``bias_attr=False`` leave the weight / bias out,
as in JAX.  ``SpectralNorm`` keeps JAX's ``weight_u`` / ``weight_v``
buffers (N(0, 1) draws through ``create_parameter``, so a global
initializer reaches them as in JAX), runs its power iterations from them
in the op and rebinds them to the iterates after each call."""

from __future__ import annotations

import math

import torch

from ...ops.dispatch import apply, as_tensor
from ...tensor.creation import ones, zeros
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "RMSNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "GroupNorm",
           "LocalResponseNorm", "SpectralNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True)
        self.register_buffer("_mean", zeros([num_features]))
        self.register_buffer("_variance", ones([num_features]))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, weight=self.weight,
            bias=self.bias, training=self.training,
            momentum=self._momentum, epsilon=self._epsilon,
            data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format == "NCL"
                         else data_format, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """``BatchNorm`` in one process (JAX's SPMD program takes the global
    batch's statistics itself).  With a process group of more than one
    rank the statistics would have to be all-reduced, which is not ported:
    the forward raises."""

    def forward(self, x):
        dist = torch.distributed
        if self.training and dist.is_available() and \
                dist.is_initialized() and dist.get_world_size() > 1:
            raise NotImplementedError(
                "SyncBatchNorm across processes needs the data-parallel "
                "lane (ROADMAP.md queue 1 item 9(a)); one process runs it "
                "as BatchNorm")
        return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            new = cls(layer._num_features, layer._momentum, layer._epsilon,
                      data_format=layer._data_format)
            new.weight = layer.weight
            new.bias = layer.bias
            new.register_buffer("_mean", layer._mean)
            new.register_buffer("_variance", layer._variance)
            return new
        for name, sub in list(layer._sub_layers.items()):
            layer._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else \
            self.create_parameter(self._normalized_shape, attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, weight=self.weight,
                            bias=self.bias, epsilon=self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self._epsilon)


def _affine(layer, n, weight_attr, bias_attr):
    layer.weight = None if weight_attr is False else layer.create_parameter(
        [n], attr=weight_attr, default_initializer=I.Constant(1.0))
    layer.bias = None if bias_attr is False else layer.create_parameter(
        [n], attr=bias_attr, is_bias=True)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        _affine(self, num_features, weight_attr, bias_attr)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        _affine(self, num_channels, weight_attr, bias_attr)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, epsilon=self._epsilon,
                            weight=self.weight, bias=self.bias)

    def extra_repr(self):
        return f"num_groups={self._num_groups}"


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """``weight / sigma``, sigma from ``power_iters`` power iterations over
    the weight viewed as ``[shape[dim], -1]``, started from the buffers."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[dim]
        w = math.prod(weight_shape) // h
        self.register_buffer("weight_u", self.create_parameter(
            [h], default_initializer=I.Normal(0, 1)).detach())
        self.register_buffer("weight_v", self.create_parameter(
            [w], default_initializer=I.Normal(0, 1)).detach())

    def forward(self, weight):
        dim, iters, eps = self._dim, self._power_iters, self._epsilon

        def fn(wt, u, v):
            mat = wt.movedim(dim, 0).reshape(wt.shape[dim], -1)
            for _ in range(iters):
                v = mat.T @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = mat @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            sigma = u @ mat @ v
            return wt / sigma, u.detach(), v.detach()

        out, u_new, v_new = apply("spectral_norm", fn, as_tensor(weight),
                                  self.weight_u, self.weight_v)
        self.weight_u._data = u_new._data
        self.weight_v._data = v_new._data
        return out
