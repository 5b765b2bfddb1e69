"""paddle.callbacks: the hapi callbacks (``hapi/callbacks.py``)."""

from .hapi.callbacks import (  # noqa: F401
    Callback, ProgBarLogger, ModelCheckpoint, EarlyStopping, LRScheduler,
    VisualDL)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "VisualDL"]
