"""paddle.nn (counterpart of ``paddle_tpu/nn/``), whole: ``Layer`` and its
containers, the common layers (``Linear``, ``Embedding``, the dropouts,
pads, ``Upsample``, shuffles, ``Fold`` / ``Unfold``, ...), the
convolutions and their transposes, the pools, the norms, every activation
and loss layer of JAX's, the recurrent layers (``nn/layer/rnn.py``), the
Transformer family (``nn/layer/transformer.py``), the long tail with
``BeamSearchDecoder`` / ``dynamic_decode`` (``nn/layer/extras.py``), the
gradient clips (``ClipGradByValue``, ``ClipGradByNorm``,
``ClipGradByGlobalNorm``, ``clip_grad_norm_``, ``clip_grad_value_``),
``functional`` and ``initializer``."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from ..framework.param import Parameter, ParamAttr  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_, clip_grad_value_)
from .layer.activation import *  # noqa: F401,F403
from .layer.common import *  # noqa: F401,F403
from .layer.conv import *  # noqa: F401,F403
from .layer.extras import *  # noqa: F401,F403
from .layer.layers import (Layer, LayerList, ParameterList,  # noqa: F401
                           Sequential, disable_static, enable_static,
                           in_dynamic_mode)
from .layer.loss import *  # noqa: F401,F403
from .layer.norm import *  # noqa: F401,F403
from .layer.pooling import *  # noqa: F401,F403
from .layer.rnn import *  # noqa: F401,F403
from .layer.transformer import *  # noqa: F401,F403
