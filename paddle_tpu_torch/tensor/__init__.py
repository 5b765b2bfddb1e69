"""paddle.tensor: the op surface, and Tensor's methods.

Counterpart of ``paddle_tpu/tensor/__init__.py``, which attaches the op
functions to Tensor as methods and operators (the ``_`` forms included).
"""

from __future__ import annotations

from . import creation, extras, inplace  # noqa: F401
from . import linalg, logic, manipulation, math, random, search, stat
from .creation import *  # noqa: F401,F403
from .einsum import einsum  # noqa: F401
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .inplace import *  # noqa: F401,F403
from .tensor import Tensor, is_tensor, to_tensor, wrap_array  # noqa: F401

# functions of the modules that are not Tensor methods (JAX's list)
_NOT_METHODS = {
    "to_tensor", "wrap_array", "is_tensor", "meshgrid",
    "broadcast_tensors", "add_n", "concat", "stack", "hstack",
    "vstack", "dstack", "column_stack", "row_stack", "einsum",
    "multi_dot", "pad_sequences", "zeros", "ones", "full", "empty",
    "arange", "linspace", "logspace", "eye", "tril_indices",
    "triu_indices", "rand", "randn", "randint", "randperm",
    "uniform", "normal", "standard_normal", "create_parameter",
    "assign", "scatter_nd", "broadcast_shape",
    "block_diag", "set_printoptions", "disable_signal_handler",
    "check_shape", "flops", "LazyGuard", "batch",
}


def _patch_tensor_methods() -> None:
    for mod in (math, manipulation, linalg, logic, search, stat, creation,
                random, extras, inplace):
        for name in mod.__all__:
            fn = getattr(mod, name, None)
            if name in _NOT_METHODS or fn is None or not callable(fn):
                continue
            if not hasattr(Tensor, name):
                setattr(Tensor, name, fn)
    Tensor.astype = manipulation.astype
    Tensor.cast = manipulation.cast
    Tensor.reshape = manipulation.reshape
    Tensor.clone = creation.clone
    Tensor.tolist = manipulation.tolist
    Tensor.fill_ = manipulation.fill_
    Tensor.zero_ = manipulation.zero_
    Tensor.uniform_ = random.uniform_
    Tensor.normal_ = random.normal_
    Tensor.exponential_ = random.exponential_
    Tensor.bernoulli_ = random.bernoulli_

    Tensor.__add__ = lambda s, o: math.add(s, o)
    Tensor.__radd__ = lambda s, o: math.add(o, s)
    Tensor.__sub__ = lambda s, o: math.subtract(s, o)
    Tensor.__rsub__ = lambda s, o: math.subtract(o, s)
    Tensor.__mul__ = lambda s, o: math.multiply(s, o)
    Tensor.__rmul__ = lambda s, o: math.multiply(o, s)
    Tensor.__truediv__ = lambda s, o: math.divide(s, o)
    Tensor.__rtruediv__ = lambda s, o: math.divide(o, s)
    Tensor.__floordiv__ = lambda s, o: math.floor_divide(s, o)
    Tensor.__rfloordiv__ = lambda s, o: math.floor_divide(o, s)
    Tensor.__mod__ = lambda s, o: math.mod(s, o)
    Tensor.__rmod__ = lambda s, o: math.mod(o, s)
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
    Tensor.__invert__ = lambda s: math.logical_not(s) \
        if s.dtype == "bool" else math.bitwise_not(s)
    Tensor.__and__ = lambda s, o: (
        math.logical_and(s, o) if s.dtype == "bool"
        else math.bitwise_and(s, o))
    Tensor.__or__ = lambda s, o: (
        math.logical_or(s, o) if s.dtype == "bool"
        else math.bitwise_or(s, o))
    Tensor.__xor__ = lambda s, o: (
        math.logical_xor(s, o) if s.dtype == "bool"
        else math.bitwise_xor(s, o))
    Tensor.__lshift__ = lambda s, o: math.left_shift(s, o)
    Tensor.__rshift__ = lambda s, o: math.right_shift(s, o)
    Tensor.__getitem__ = manipulation.getitem
    Tensor.__setitem__ = manipulation.setitem
    Tensor.T = property(lambda s: manipulation.transpose(s))
    Tensor.mT = property(lambda s: manipulation.swapaxes(s, -1, -2))
    Tensor.dim = lambda s: s.ndim
    Tensor.ndimension = lambda s: s.ndim
    Tensor.element_size = lambda s: s.dtype.itemsize
    Tensor.nelement = lambda s: s.size
    Tensor._to = Tensor.to


_patch_tensor_methods()
