"""paddle.tensor: the op surface this slice ports, and Tensor's methods.

Counterpart of ``paddle_tpu/tensor/__init__.py``, which attaches the op
functions to Tensor as methods and operators; here for the ops of
``creation``, ``manipulation``, ``math``, ``logic``, ``linalg`` and
``search`` only.
"""

from __future__ import annotations

from . import creation, linalg, logic, manipulation, math, search
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .tensor import Tensor, is_tensor, to_tensor, wrap_array  # noqa: F401


def _patch_tensor_methods() -> None:
    skip = {"to_tensor", "zeros", "ones", "full", "arange", "randint",
            "randn", "concat", "stack"}
    for mod in (math, manipulation, linalg, logic, search, creation):
        for name in mod.__all__:
            if name not in skip and not hasattr(Tensor, name):
                setattr(Tensor, name, getattr(mod, name))
    Tensor.astype = manipulation.astype
    Tensor.cast = manipulation.cast
    Tensor.reshape = manipulation.reshape
    Tensor.clone = creation.clone
    Tensor.tolist = manipulation.tolist

    Tensor.__add__ = lambda s, o: math.add(s, o)
    Tensor.__radd__ = lambda s, o: math.add(o, s)
    Tensor.__sub__ = lambda s, o: math.subtract(s, o)
    Tensor.__rsub__ = lambda s, o: math.subtract(o, s)
    Tensor.__mul__ = lambda s, o: math.multiply(s, o)
    Tensor.__rmul__ = lambda s, o: math.multiply(o, s)
    Tensor.__truediv__ = lambda s, o: math.divide(s, o)
    Tensor.__rtruediv__ = lambda s, o: math.divide(o, s)
    Tensor.__pow__ = lambda s, o: math.pow(s, o)
    Tensor.__rpow__ = lambda s, o: math.pow(o, s)
    Tensor.__neg__ = lambda s: math.neg(s)
    Tensor.__abs__ = lambda s: math.abs(s)
    Tensor.__matmul__ = lambda s, o: linalg.matmul(s, o)
    Tensor.__rmatmul__ = lambda s, o: linalg.matmul(o, s)
    Tensor.__eq__ = lambda s, o: logic.equal(s, o)
    Tensor.__ne__ = lambda s, o: logic.not_equal(s, o)
    Tensor.__lt__ = lambda s, o: logic.less_than(s, o)
    Tensor.__le__ = lambda s, o: logic.less_equal(s, o)
    Tensor.__gt__ = lambda s, o: logic.greater_than(s, o)
    Tensor.__ge__ = lambda s, o: logic.greater_equal(s, o)
    Tensor.__hash__ = object.__hash__
    Tensor.__getitem__ = manipulation.getitem
    Tensor.T = property(lambda s: manipulation.transpose(s))
    Tensor.dim = lambda s: s.ndim


_patch_tensor_methods()
