"""paddle.incubate: the fused functional ops (``incubate.nn.functional``)
and the one-program training step, ``jit_train_step`` / ``jit_eval_step``
(``incubate/jit_train.py``)."""

from . import nn  # noqa: F401
from .jit_train import jit_eval_step, jit_train_step  # noqa: F401
