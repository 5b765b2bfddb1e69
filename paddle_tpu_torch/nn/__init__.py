"""paddle.nn for the layers the port carries (counterpart of
``paddle_tpu/nn/``): ``Layer`` and its containers, ``Linear``,
``Embedding``, ``Dropout``, ``Conv1D`` / ``2D`` / ``3D``, the max, average
and adaptive average pools, ``BatchNorm`` (``1D`` / ``2D`` / ``3D``,
``SyncBatchNorm``), ``LayerNorm``, ``RMSNorm``, every activation layer of
JAX's (``ReLU``, ``ReLU6``, ``GELU``, ``Hardswish``, ``PReLU``, ...),
``CrossEntropyLoss``, the gradient clips (``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm``, ``clip_grad_norm_``,
``clip_grad_value_``), ``functional`` and ``initializer``.  The rest of
JAX's ``nn`` (the losses, norms, padding, transformer and rnn layers) is
not ported yet (ROADMAP.md queue 1 items 10(a) and 10(c))."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from ..framework.param import Parameter, ParamAttr  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_, clip_grad_value_)
from .layer.activation import (  # noqa: F401
    CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    RReLU, Sigmoid, Silu, Softmax, Softplus, Softshrink, Softsign, Swish,
    Tanh, Tanhshrink, ThresholdedReLU)
from .layer.common import Dropout, Embedding, Linear  # noqa: F401
from .layer.conv import Conv1D, Conv2D, Conv3D  # noqa: F401
from .layer.layers import (Layer, LayerList, ParameterList,  # noqa: F401
                           Sequential, disable_static, enable_static,
                           in_dynamic_mode)
from .layer.loss import CrossEntropyLoss  # noqa: F401
from .layer.norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                         BatchNorm3D, LayerNorm, RMSNorm, SyncBatchNorm)
from .layer.pooling import (AdaptiveAvgPool1D,  # noqa: F401
                            AdaptiveAvgPool2D, AdaptiveAvgPool3D, AvgPool1D,
                            AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                            MaxPool3D)
