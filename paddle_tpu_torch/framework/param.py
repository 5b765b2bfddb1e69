"""Parameter and ParamAttr.

Counterpart of ``paddle_tpu/framework/param.py``: a Parameter is a
trainable Tensor (``stop_gradient=False``, persistable).
"""

from __future__ import annotations

from typing import Any, Optional

from ..tensor.tensor import Tensor

__all__ = ["Parameter", "ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr) -> Optional["ParamAttr"]:
        if attr is None:
            return ParamAttr()
        if attr is False:
            return None
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)        # an initializer


class Parameter(Tensor):
    """A trainable tensor; its data is a leaf ``torch.Tensor`` that
    requires grad unless ``trainable`` is False."""

    def __init__(self, data: Any = None, dtype: Any = None,
                 name: Optional[str] = None, trainable: bool = True,
                 attr: Optional[ParamAttr] = None):
        super().__init__(data, dtype=dtype, stop_gradient=not trainable,
                         name=name)
        self.persistable = True
        self._is_param = True
        self.optimize_attr = {"learning_rate":
                              attr.learning_rate if attr else 1.0}
        self.regularizer = attr.regularizer if attr else None
        self.need_clip = attr.need_clip if attr else True

    @property
    def trainable(self) -> bool:
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, v: bool) -> None:
        self.stop_gradient = not v

    def __repr__(self) -> str:
        return "Parameter containing:\n" + super().__repr__()
