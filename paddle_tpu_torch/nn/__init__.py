"""paddle.nn for the layers this slice ports (counterpart of
``paddle_tpu/nn/``): ``Layer`` and its containers, ``Linear``,
``Embedding``, ``RMSNorm``, ``Silu``, ``CrossEntropyLoss``, ``functional``
and ``initializer``.  The rest of JAX's ``nn`` is not ported yet
(ROADMAP.md queue 1 item 10)."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from ..framework.param import Parameter, ParamAttr  # noqa: F401
from .layer.activation import Silu  # noqa: F401
from .layer.common import Embedding, Linear  # noqa: F401
from .layer.layers import (Layer, LayerList, ParameterList,  # noqa: F401
                           Sequential)
from .layer.loss import CrossEntropyLoss  # noqa: F401
from .layer.norm import RMSNorm  # noqa: F401
