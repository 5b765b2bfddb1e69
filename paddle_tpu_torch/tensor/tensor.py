"""The user-facing Tensor: a handle over a ``torch.Tensor`` ``_data``.

Counterpart of ``paddle_tpu/tensor/tensor.py``.  Autograd is torch's:
``stop_gradient`` is ``not _data.requires_grad`` (True by default, False
for parameters), an op on tensors that need grad is recorded by torch as
it runs, and ``backward`` / ``grad`` / hooks go to torch's engine
(``autograd/tape.py``).  A leaf's gradient lives on ``_data.grad``.

Arithmetic and most methods are attached to the class by ``tensor/``'s
op modules (``tensor/__init__.py``), as in JAX.

In-place ops (the ``op_`` forms, ``x[i] = v``) compute out of place and
rebind ``_data`` (:meth:`Tensor._inplace_assign`), as JAX's do: an op that
read the tensor earlier keeps the old value and its gradient.  A leaf that
requires grad and is changed under ``no_grad`` (an update of a parameter)
keeps requiring it: its storage takes the new values, so optimizers and
CUDA graphs that hold the storage see them.  That write is the one place
an earlier reader can still meet torch's version counter: a backward
through an op that saved the parameter before the write raises, where
JAX's tape keeps the old value (ROADMAP.md queue 3).

:func:`forbid_host_reads` marks a block (this thread only) in which a
host read of a Tensor's values (``numpy``, ``item``, ``tolist``, ``bool``,
``int``, ``float``, ``index``) raises :class:`HostReadError`, as a JAX
tracer does: ``jit.to_static`` runs a signature's first call under it to
find a graph break, and a CUDA graph capture and an export run under it,
where a host read would fail or bake a value in.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..framework import dtype as dtypes
from ..framework import place as places

__all__ = ["Tensor", "is_tensor", "wrap_array", "to_tensor",
           "HostReadError", "forbid_host_reads", "host_reads_forbidden"]


class HostReadError(RuntimeError):
    """A host read of a Tensor's values inside :func:`forbid_host_reads`
    (a graph break of ``jit.to_static``, or a read an export cannot
    take)."""


_host_reads = threading.local()


@contextlib.contextmanager
def forbid_host_reads(where: str):
    """Inside the block (this thread), a host read of any Tensor's values
    raises :class:`HostReadError` naming the read and ``where``."""
    prev = getattr(_host_reads, "where", None)
    _host_reads.where = where
    try:
        yield
    finally:
        _host_reads.where = prev


def host_reads_forbidden() -> Optional[str]:
    """``where`` of the innermost :func:`forbid_host_reads` block, or
    None."""
    return getattr(_host_reads, "where", None)


def _host_read(what: str) -> None:
    where = getattr(_host_reads, "where", None)
    if where is not None:
        raise HostReadError(
            f"{what} reads a Tensor's values on the host inside {where}, "
            f"where the values are not there yet (a graph break)")


class Tensor:
    __slots__ = ("_data", "name", "persistable", "_is_param", "__weakref__",
                 "__dict__")

    _name_counter = [0]

    def __init__(self, data: Any = None, dtype: Any = None, place=None,
                 stop_gradient: bool = True, name: Optional[str] = None):
        if data is None:
            data = torch.zeros((), dtype=dtypes.to_torch_dtype(
                dtype or "float32"))
        self._data = _to_torch(data, dtype, place)
        if name is None:
            Tensor._name_counter[0] += 1
            name = f"generated_tensor_{Tensor._name_counter[0]}"
        self.name = name
        self.persistable = False
        self._is_param = False
        self.stop_gradient = stop_gradient

    # -- meta ---------------------------------------------------------------
    @property
    def shape(self) -> List[int]:
        return list(self._data.shape)

    @property
    def dtype(self) -> dtypes.DType:
        return dtypes.convert_dtype(self._data.dtype)

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def place(self):
        d = self._data.device
        return places.CPUPlace() if d.type == "cpu" else \
            places.CUDAPlace(d.index or 0)

    @property
    def is_leaf(self) -> bool:
        return self._data.grad_fn is None

    @property
    def _grad_node(self):
        return self._data.grad_fn

    # -- autograd -----------------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        d = self._data
        if value:
            if d.requires_grad:
                self._data = d.detach() if d.grad_fn is not None else \
                    d.requires_grad_(False)
        elif not d.requires_grad and (d.is_floating_point() or
                                      d.is_complex()):
            d.requires_grad_(True)

    @property
    def grad(self) -> Optional["Tensor"]:
        d = self.__dict__.get("_grad_leaf", self._data)
        g = d.grad if (d.grad_fn is None or d.retains_grad) else None
        if g is None:
            return None
        t = wrap_array(g)
        t.name = self.name + "@GRAD"
        return t

    @grad.setter
    def grad(self, value) -> None:
        d = self.__dict__.get("_grad_leaf", self._data)
        d.grad = None if value is None else unwrap_data(value)

    def backward(self, grad_tensor: Optional["Tensor"] = None,
                 retain_graph: bool = False) -> None:
        from ..autograd import tape
        tape.run_backward([self], [grad_tensor], retain_graph=retain_graph)

    def clear_grad(self) -> None:
        self.__dict__.get("_grad_leaf", self._data).grad = None

    clear_gradient = clear_grad

    def register_hook(self, hook: Callable):
        """``hook(grad) -> grad or None`` on the gradient flowing into this
        tensor (once, on the accumulated total)."""
        def call(g):
            out = hook(wrap_array(g))
            return None if out is None else unwrap_data(out)
        return self._data.register_hook(call)

    def detach(self) -> "Tensor":
        t = wrap_array(self._data.detach())
        t.name = self.name + ".detach"
        return t

    def detach_(self) -> "Tensor":
        self._data = self._data.detach()
        return self

    # -- value access -------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """The values as a numpy array (bf16 comes back as float32: numpy
        has no bfloat16 of its own)."""
        _host_read("Tensor.numpy()")
        d = self._data.detach()
        if d.dtype == torch.bfloat16:
            d = d.float()
        return d.cpu().numpy()

    def item(self, *args) -> Any:
        _host_read("Tensor.item()")
        if args:
            return self.numpy().item(*args)
        return self._data.item()

    def tolist(self):
        _host_read("Tensor.tolist()")
        return self.numpy().tolist()

    def __len__(self) -> int:
        if self._data.dim() == 0:
            raise TypeError("len() of a 0-D tensor")
        return self._data.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __int__(self):
        _host_read("int(Tensor)")
        return int(self.item())

    def __float__(self):
        _host_read("float(Tensor)")
        return float(self.item())

    def __bool__(self):
        _host_read("bool(Tensor)")
        if self._data.numel() != 1:
            raise ValueError("The truth value of a Tensor with more than "
                             "one element is ambiguous.")
        return bool(self.item())

    def __index__(self):
        _host_read("Tensor.__index__")
        return int(self.item())

    def __format__(self, spec):
        if self._data.numel() == 1:
            return format(self.item(), spec)
        return format(self.numpy(), spec)

    def __repr__(self) -> str:
        body = np.array2string(self.numpy(), precision=8, separator=", ")
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},\n"
                f"       {body})")

    __hash__ = object.__hash__

    # -- in-place machinery -------------------------------------------------
    def _inplace_assign(self, new_tensor: "Tensor") -> "Tensor":
        """Rebind this handle to ``new_tensor``'s data (JAX's
        ``_inplace_assign``).  JAX only ever clears ``stop_gradient``
        here, so a tensor that requires grad keeps requiring it when the
        new data does not (a result computed under ``no_grad``): a leaf of
        the same shape and type takes the values into its own storage,
        anything else is rebound to a fresh leaf."""
        src = new_tensor._data if isinstance(new_tensor, Tensor) else \
            new_tensor
        d = self._data
        if d.requires_grad and d.grad_fn is None and src.grad_fn is not None:
            # a leaf rebound to a result of the graph: its gradient (the
            # old value's, as JAX's tape keeps it on the handle) stays
            # readable through ``grad``
            self.__dict__.setdefault("_grad_leaf", d)
        if d.requires_grad and not src.requires_grad:
            if d.grad_fn is None and src.shape == d.shape and \
                    src.dtype == d.dtype:
                with torch.no_grad():
                    d.copy_(src)
                return self
            src = src.detach()
            if src.is_floating_point() or src.is_complex():
                src.requires_grad_(True)
        self._data = src
        return self

    def copy_(self, other, blocking: bool = True) -> "Tensor":
        """This tensor's values replaced by ``other``'s, in its type."""
        src = unwrap_data(other) if isinstance(other, Tensor) else \
            _to_torch(other, None, None, device=self._data.device)
        src = src.to(device=self._data.device, dtype=self._data.dtype)
        return self._inplace_assign(src)

    def get_tensor(self) -> "Tensor":
        return self

    # -- value replacement --------------------------------------------------
    def set_value(self, value) -> None:
        """New values of this tensor's shape, in its type and on its
        device; a parameter stays a leaf with its ``stop_gradient``."""
        src = unwrap_data(value) if isinstance(value, Tensor) else \
            _to_torch(value, None, None, device=self._data.device)
        if tuple(src.shape) != tuple(self._data.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(src.shape)} "
                             f"vs {tuple(self._data.shape)}")
        keep = self.stop_gradient
        self._data = src.detach().to(device=self._data.device,
                                     dtype=self._data.dtype, copy=True)
        self.stop_gradient = keep

    # -- device movement ----------------------------------------------------
    def to(self, *args, **kwargs) -> "Tensor":
        device = kwargs.get("device")
        dtype_arg = kwargs.get("dtype")
        for a in args:
            if isinstance(a, dtypes.DType) or isinstance(a, torch.dtype) or (
                    isinstance(a, str) and a.replace("paddle.", "")
                    in dtypes._BY_NAME):
                dtype_arg = a
            else:
                device = a
        data = self._data
        if dtype_arg is not None:
            data = data.to(dtypes.to_torch_dtype(dtype_arg))
        if device is not None:
            data = data.to(places._parse_device(device).torch_device())
        return wrap_array(data)

    def cpu(self) -> "Tensor":
        return self.to(device="cpu")

    def cuda(self, device_id=0, blocking=True) -> "Tensor":
        return self.to(device=f"gpu:{device_id}")

    def tpu(self, device_id=0) -> "Tensor":
        raise NotImplementedError(
            "the port runs on 'cpu' or 'gpu'; it has no TPU place")

    def pin_memory(self) -> "Tensor":
        d = self._data
        return wrap_array(d.pin_memory() if d.device.type == "cpu" and
                          torch.cuda.is_available() else d)

    def contiguous(self) -> "Tensor":
        return wrap_array(self._data.contiguous())

    def is_contiguous(self) -> bool:
        return self._data.is_contiguous()

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        return (self._data,), (self.stop_gradient,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return wrap_array(children[0], stop_gradient=aux[0])


def unwrap_data(x):
    return x._data if isinstance(x, Tensor) else x


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if "bfloat16" in str(a.dtype):
        # numpy's bfloat16 is an extension type torch does not read
        return torch.from_numpy(np.ascontiguousarray(a).view(
            np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _to_torch(data, dtype=None, place=None, device=None) -> torch.Tensor:
    """JAX's ``_to_jax_array`` rules: a Tensor's or torch tensor's own type,
    a numpy array's own type, Python bool / int / float as bool / int64 /
    the default float type, a nested list with floats as the default float
    type; then ``dtype`` if given, on ``place`` (a torch tensor stays where
    it is, everything else goes to the current place)."""
    tdt = dtypes.to_torch_dtype(dtype)
    if isinstance(data, Tensor):
        arr = data._data.detach()
    elif isinstance(data, torch.Tensor):
        arr = data.detach()
    elif isinstance(data, np.ndarray):
        arr = _from_numpy(data)
        if device is None and place is None:
            device = places.current_torch_device()
    else:
        if isinstance(data, (bool, int, float, complex)):
            if tdt is None:
                if isinstance(data, bool):
                    tdt = torch.bool
                elif isinstance(data, int):
                    tdt = torch.int64
                elif isinstance(data, float):
                    tdt = dtypes.default_float_dtype().torch_dtype
                else:
                    tdt = torch.complex64
            arr = torch.tensor(data, dtype=tdt)
        else:
            np_arr = np.asarray(data)
            if tdt is None and np_arr.dtype == np.float64:
                tdt = dtypes.default_float_dtype().torch_dtype
            arr = _from_numpy(np_arr)
        if device is None and place is None:
            device = places.current_torch_device()
    if place is not None:
        device = places._parse_device(place).torch_device()
    if tdt is not None and arr.dtype != tdt:
        arr = arr.to(tdt)
    if device is not None and arr.device != torch.device(device):
        arr = arr.to(device)
    return arr


def wrap_array(arr: torch.Tensor, stop_gradient: Optional[bool] = None
               ) -> Tensor:
    """A Tensor over ``arr`` itself (no copy).  ``stop_gradient`` follows
    ``arr.requires_grad`` unless given."""
    t = Tensor.__new__(Tensor)
    t._data = arr
    Tensor._name_counter[0] += 1
    t.name = f"generated_tensor_{Tensor._name_counter[0]}"
    t.persistable = False
    t._is_param = False
    if stop_gradient is not None:
        t.stop_gradient = stop_gradient
    return t


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """Mirror of ``paddle.to_tensor``."""
    return Tensor(data, dtype=dtype, place=place,
                  stop_gradient=stop_gradient)


def is_tensor(x) -> bool:
    return isinstance(x, Tensor)
