"""``paddle.save`` / ``paddle.load`` (counterpart of
``paddle_tpu/framework/io.py``): a pickle of the object with each Tensor
replaced by JAX's record, ``{"__type__": "paddle_tpu.Tensor", "data":
numpy array, "stop_gradient", "name", "dtype"}``, so a file written by
either package loads in the other.

``data`` is the Tensor's ``numpy()``: a bf16 Tensor is written as f32
values (numpy has no bfloat16 of its own) with ``"dtype": "bfloat16"``,
and this package loads it back as bf16; JAX's ``load`` keeps the f32.  A
bf16 array written by JAX (an ``ml_dtypes`` array) loads as bf16.  Loaded
Tensors go to the current place, the card unless
``paddle.set_device("cpu")``."""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np

from . import dtype as dtypes
from ..tensor.tensor import Tensor, _from_numpy, wrap_array

__all__ = ["save", "load"]

_PROTO_TAG = "paddle_tpu.Tensor"


def _pack(obj: Any) -> Any:
    if isinstance(obj, Tensor):
        return {"__type__": _PROTO_TAG, "data": obj.numpy(),
                "stop_gradient": obj.stop_gradient, "name": obj.name,
                "dtype": str(obj.dtype)}
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return packed if isinstance(obj, list) else tuple(packed)
    return obj


def _unpack(obj: Any) -> Any:
    if isinstance(obj, dict):
        if obj.get("__type__") == _PROTO_TAG:
            from .place import current_torch_device
            data = _from_numpy(np.asarray(obj["data"]))
            want = dtypes.to_torch_dtype(obj.get("dtype")) \
                if obj.get("dtype") in dtypes._BY_NAME else None
            if want is not None and want != data.dtype:
                data = data.to(want)
            t = wrap_array(data.to(current_torch_device()),
                           stop_gradient=obj.get("stop_gradient", True))
            t.name = obj.get("name", t.name)
            return t
        return {k: _unpack(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v) for v in obj)
    return obj


def save(obj: Any, path, protocol: int = 4, **configs) -> None:
    """Mirror of ``paddle.save``."""
    if hasattr(path, "write"):
        pickle.dump(_pack(obj), path, protocol=protocol)
        return
    path = str(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, **configs) -> Any:
    """Mirror of ``paddle.load``."""
    if hasattr(path, "read"):
        return _unpack(pickle.load(path))
    with open(str(path), "rb") as f:
        return _unpack(pickle.load(f))
