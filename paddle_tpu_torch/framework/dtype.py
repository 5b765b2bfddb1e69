"""Paddle's dtype names over torch dtypes.

Counterpart of ``paddle_tpu/framework/dtype.py``: ``paddle.float32`` and
the rest are singleton :class:`DType` objects accepted anywhere a dtype is;
they compare equal to their names, to numpy dtypes and to the torch dtype
they stand for.  :func:`get_default_dtype` / :func:`set_default_dtype` hold
the float type a Python float or a float64 array becomes.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

__all__ = [
    "DType", "dtype", "convert_dtype", "to_torch_dtype",
    "bool_", "uint8", "int8", "int16", "int32", "int64",
    "float16", "bfloat16", "float32", "float64",
    "complex64", "complex128",
    "get_default_dtype", "set_default_dtype", "iinfo", "finfo",
]


class DType:
    """A framework dtype: hashable, comparable to strings, numpy dtypes and
    torch dtypes."""

    __slots__ = ("name", "torch_dtype")

    def __init__(self, name: str, torch_dtype) -> None:
        self.name = name
        self.torch_dtype = torch_dtype

    def __repr__(self) -> str:
        return f"paddle.{self.name}"

    def __str__(self) -> str:
        return self.name

    def __hash__(self) -> int:
        return hash(self.name)

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, DType):
            return self.name == other.name
        if isinstance(other, str):
            return self.name == other.replace("paddle.", "")
        if isinstance(other, torch.dtype):
            return self.torch_dtype == other
        try:
            return convert_dtype(other) is self
        except TypeError:
            return NotImplemented

    @property
    def is_floating_point(self) -> bool:
        return self.torch_dtype.is_floating_point

    @property
    def is_complex(self) -> bool:
        return self.torch_dtype.is_complex

    @property
    def itemsize(self) -> int:
        return self.torch_dtype.itemsize


bool_ = DType("bool", torch.bool)
uint8 = DType("uint8", torch.uint8)
int8 = DType("int8", torch.int8)
int16 = DType("int16", torch.int16)
int32 = DType("int32", torch.int32)
int64 = DType("int64", torch.int64)
float16 = DType("float16", torch.float16)
bfloat16 = DType("bfloat16", torch.bfloat16)
float32 = DType("float32", torch.float32)
float64 = DType("float64", torch.float64)
complex64 = DType("complex64", torch.complex64)
complex128 = DType("complex128", torch.complex128)

_ALL = [bool_, uint8, int8, int16, int32, int64, float16, bfloat16,
        float32, float64, complex64, complex128]
_BY_NAME = {d.name: d for d in _ALL}
_BY_NAME.update(bool_=bool_, float=float32, double=float64, half=float16,
                int=int32, long=int64)
_BY_TORCH = {d.torch_dtype: d for d in _ALL}

dtype = DType  # paddle.dtype


def convert_dtype(d: Any) -> Optional[DType]:
    """Any dtype spec (DType, name, torch / numpy dtype, Python type) as a
    :class:`DType`; ``None`` stays ``None``."""
    if d is None or isinstance(d, DType):
        return d
    if isinstance(d, torch.dtype):
        if d in _BY_TORCH:
            return _BY_TORCH[d]
        raise TypeError(f"unsupported dtype: {d!r}")
    if isinstance(d, str):
        key = d.replace("paddle.", "")
        if key in _BY_NAME:
            return _BY_NAME[key]
    if "bfloat16" in str(d):
        return bfloat16
    name = np.dtype(d).name
    if name in _BY_NAME:
        return _BY_NAME[name]
    raise TypeError(f"unsupported dtype: {d!r}")


def to_torch_dtype(d: Any):
    dt = convert_dtype(d)
    return None if dt is None else dt.torch_dtype


_default_dtype = float32


def get_default_dtype() -> str:
    return _default_dtype.name


def set_default_dtype(d: Any) -> None:
    global _default_dtype
    dt = convert_dtype(d)
    if not dt.is_floating_point:
        raise TypeError("default dtype must be floating point")
    _default_dtype = dt


def default_float_dtype() -> DType:
    return _default_dtype



class iinfo:
    """The range of an integer type (``paddle.iinfo``)."""

    def __init__(self, d):
        info = torch.iinfo(to_torch_dtype(d))
        self.min, self.max, self.bits = int(info.min), int(info.max), \
            info.bits
        self.dtype = str(convert_dtype(d))


class finfo:
    """The limits of a float type (``paddle.finfo``)."""

    def __init__(self, d):
        dt = convert_dtype(d)
        info = torch.finfo(dt.torch_dtype)
        self.min = float(info.min)
        self.max = float(info.max)
        self.eps = float(info.eps)
        self.tiny = float(info.tiny)
        self.smallest_normal = float(info.tiny)
        self.resolution = float(torch.tensor(info.resolution,
                                             dtype=dt.torch_dtype))
        self.bits = info.bits
        self.dtype = str(dt)
