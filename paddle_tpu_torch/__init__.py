"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu for NVIDIA Hopper.

The port runs the LLaMA serving path of ``paddle_tpu`` (HTTP front,
continuous-batching engine, packed prefill, paged decode) and its training
step in PyTorch, with hand-written CUDA kernels for sm_90a where the JAX
package has Pallas TPU kernels.  It imports neither ``jax`` nor
``paddle_tpu``.  Entry points run on the CUDA device unless the caller
passes ``device="cpu"``, where every kernel wrapper uses its plain PyTorch
version.

The namespace mirrors ``paddle`` for the dygraph core this port carries
(``import paddle_tpu_torch as paddle``): ``to_tensor`` and the tensor ops,
``backward`` / ``grad`` / ``no_grad``, ``nn`` (whole: ``Layer`` and its
containers, the convolutions and pools, the norms, every activation and
loss, ``Transformer``, the RNNs, ``BeamSearchDecoder``, the gradient
clips, ``functional``, ``initializer``),
``optimizer`` (``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``lr``), ``amp``
(``auto_cast``, ``decorate``, ``GradScaler``), ``incubate``
(``nn.functional``, ``jit_train_step``), ``io`` (``DataLoader`` and the
datasets), ``metric``, ``Model`` / ``summary`` / ``callbacks`` (hapi),
``vision`` (LeNet, ResNet, VGG, MobileNet v1 / v2 / v3, AlexNet,
SqueezeNet, DenseNet, GoogLeNet, InceptionV3, ShuffleNetV2, datasets,
transforms), ``linalg``, ``save`` / ``load``, ``jit`` (``to_static``,
``save`` / ``load``), ``static`` (``Program``, ``Executor``, the inference
models) and ``inference`` (``Config``, ``Predictor``,
``convert_to_export``; ``inference.serving``'s ``InferenceServer``).  Tensors go to the
current place, the card unless ``paddle.set_device("cpu")``; on a host
without a card the default place raises when a tensor is made.

    import paddle_tpu_torch as paddle
    paddle.set_device("cpu")
    x = paddle.to_tensor([[1., 2.], [3., 4.]], stop_gradient=False)
    paddle.matmul(x, x).sum().backward()
    print(x.grad)
"""

__version__ = "0.1.0"

from . import flags  # noqa: F401,E402 (also JAX's flags view)
from .flags import get_flags, set_flags  # noqa: F401,E402
from .framework.dtype import (  # noqa: F401,E402
    bfloat16, bool_, complex64, complex128, dtype, finfo, float16, float32,
    float64, get_default_dtype, iinfo, int8, int16, int32, int64,
    set_default_dtype, uint8)
from .framework.place import (  # noqa: F401,E402
    CPUPlace, CUDAPinnedPlace, CUDAPlace, CustomPlace, TPUPlace, XPUPlace,
    device_count, get_device, is_compiled_with_cinn, is_compiled_with_cuda,
    is_compiled_with_distribute, is_compiled_with_rocm, is_compiled_with_tpu,
    is_compiled_with_xpu, set_device)
from .framework.random import (  # noqa: F401,E402
    get_cuda_rng_state, get_rng_state, seed, set_cuda_rng_state,
    set_rng_state)
from .tensor.tensor import Tensor, is_tensor, to_tensor  # noqa: F401,E402
from . import tensor  # noqa: F401,E402
from .tensor import *  # noqa: F401,F403,E402
from . import autograd  # noqa: F401,E402
from .autograd import (  # noqa: F401,E402
    enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled)
from .framework.param import Parameter, ParamAttr  # noqa: F401,E402
from . import nn  # noqa: F401,E402
from . import optimizer  # noqa: F401,E402
from . import amp  # noqa: F401,E402
from . import incubate  # noqa: F401,E402
from . import io  # noqa: F401,E402
from . import metric  # noqa: F401,E402
from . import hapi  # noqa: F401,E402
from . import callbacks  # noqa: F401,E402
from . import vision  # noqa: F401,E402
from . import jit  # noqa: F401,E402
from . import static  # noqa: F401,E402
from . import inference  # noqa: F401,E402
from .framework.io import load, save  # noqa: F401,E402
from .hapi import Model, summary  # noqa: F401,E402
from .nn.layer.layers import (  # noqa: F401,E402
    disable_static, enable_static, in_dynamic_mode)

bool = bool_  # paddle.bool


def DataParallel(layers, *args, **kwargs):
    """``paddle.DataParallel``: not ported yet (ROADMAP.md queue 1 item
    9(a), the mesh and its parallel forms)."""
    raise NotImplementedError(
        "paddle.DataParallel is not ported yet (ROADMAP.md queue 1 item "
        "9(a))")


class _Version:
    """``paddle.version``."""

    full_version = __version__
    major, minor, patch = (int(p) for p in __version__.split("."))

    @staticmethod
    def show():
        import torch
        print(f"paddle_tpu_torch {__version__} (torch {torch.__version__}, "
              f"CUDA {torch.version.cuda})")

    @staticmethod
    def cuda():
        import torch
        return str(torch.version.cuda) if torch.version.cuda else "False"


version = _Version()
