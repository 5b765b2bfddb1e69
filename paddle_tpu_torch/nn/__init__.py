"""paddle.nn for the layers the port carries (counterpart of
``paddle_tpu/nn/``): ``Layer`` and its containers, ``Linear``,
``Embedding``, ``Dropout``, ``Conv1D`` / ``2D`` / ``3D``, the max, average
and adaptive average pools, ``BatchNorm`` (``1D`` / ``2D`` / ``3D``,
``SyncBatchNorm``), ``LayerNorm``, ``RMSNorm``, ``ReLU``, ``Silu``,
``GELU``, ``Tanh``, ``CrossEntropyLoss``, the gradient clips (``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm``, ``clip_grad_norm_``,
``clip_grad_value_``), ``functional`` and ``initializer``.  The rest of
JAX's ``nn`` is not ported yet (ROADMAP.md queue 1 item 10)."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from ..framework.param import Parameter, ParamAttr  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_, clip_grad_value_)
from .layer.activation import GELU, ReLU, Silu, Tanh  # noqa: F401
from .layer.common import Dropout, Embedding, Linear  # noqa: F401
from .layer.conv import Conv1D, Conv2D, Conv3D  # noqa: F401
from .layer.layers import (Layer, LayerList, ParameterList,  # noqa: F401
                           Sequential)
from .layer.loss import CrossEntropyLoss  # noqa: F401
from .layer.norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                         BatchNorm3D, LayerNorm, RMSNorm, SyncBatchNorm)
from .layer.pooling import (AdaptiveAvgPool1D,  # noqa: F401
                            AdaptiveAvgPool2D, AdaptiveAvgPool3D, AvgPool1D,
                            AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                            MaxPool3D)
