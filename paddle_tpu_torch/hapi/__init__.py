"""paddle.hapi: ``Model``, ``summary`` and the callbacks (counterpart of
``paddle_tpu/hapi/``)."""

from .model import Model, summary  # noqa: F401
from . import callbacks  # noqa: F401
from .callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
    VisualDL)
