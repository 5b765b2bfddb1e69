"""paddle.nn for the layers the port carries (counterpart of
``paddle_tpu/nn/``): ``Layer`` and its containers, ``Linear``,
``Embedding``, ``Dropout``, ``LayerNorm``, ``RMSNorm``, ``Silu``, ``GELU``,
``Tanh``, ``CrossEntropyLoss``, the gradient clips (``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm``, ``clip_grad_norm_``,
``clip_grad_value_``), ``functional`` and ``initializer``.  The rest of
JAX's ``nn`` is not ported yet (ROADMAP.md queue 1 item 10)."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from ..framework.param import Parameter, ParamAttr  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_, clip_grad_value_)
from .layer.activation import GELU, Silu, Tanh  # noqa: F401
from .layer.common import Dropout, Embedding, Linear  # noqa: F401
from .layer.layers import (Layer, LayerList, ParameterList,  # noqa: F401
                           Sequential)
from .layer.loss import CrossEntropyLoss  # noqa: F401
from .layer.norm import LayerNorm, RMSNorm  # noqa: F401
