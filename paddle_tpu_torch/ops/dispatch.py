"""Op application: the eager dispatch path of the Paddle API.

Counterpart of ``paddle_tpu/ops/dispatch.py``.  Every op of the API is a
torch function over the tensors' ``_data``; :func:`apply` runs it, and
torch's autograd records it when an input needs grad (there is no vjp
tape of the port's own).  The outputs come back as Tensors whose
``stop_gradient`` follows torch.

:data:`_op_table` is JAX's kernel registry: the API's functional ops look
up a kernel by JAX's name (``register_op_impl`` / ``get_op_impl``) at call
time, and the port's kernel wrappers are registered under those names
below (paddle_tpu/ops/pallas/__init__.py's list).  Each wrapper launches
its CUDA kernel on a CUDA tensor and runs its plain version on a CPU one.
Registering another function under a name re-routes every API call that
takes it (how a comparison runs the plain versions on the card).

:func:`set_amp_hook` is JAX's seam for AMP: ``paddle_tpu_torch.amp``
installs ``hook(op_name, arrays) -> arrays`` and :func:`apply` runs each op
on what it returns (torch's autograd takes the casts back to the callers'
types in the backward).  :func:`amp_cast_dtype` asks the hook, without
running an op, what type it gives an input of ``name``: a route that picks
a kernel by type (``F.sdpa_route``) decides on the type the op will see.

:func:`set_capture_hook` is JAX's seam for the static graph:
``static.program_guard`` installs ``hook(name, fn, inputs, outputs)``,
called after every op with the function it ran (the AMP cast inside) so
that ``static.Executor`` can run the recorded ops again.  Inside a block
where host reads are forbidden (``jit.to_static``'s checked runs, a CUDA
graph capture, an export) the hook is not called and the NaN / Inf check,
a host read, is skipped, as JAX skips both inside a functional trace.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from ..flags import flags
from ..tensor.tensor import (Tensor, _to_torch, host_reads_forbidden,
                             wrap_array)

__all__ = ["apply", "as_tensor", "unwrap", "register_op_impl", "get_op_impl",
           "set_amp_hook", "amp_cast_dtype", "set_capture_hook"]

_op_table: Dict[str, Callable] = {}
_amp_hook: Optional[Callable] = None
_capture_hook: Optional[Callable] = None


def set_capture_hook(hook: Optional[Callable]) -> None:
    """Installed by ``static.program_guard``: ``hook(name, fn, inputs,
    out_tensors)`` after every op, ``fn`` taking and returning torch
    tensors as the op ran them."""
    global _capture_hook
    _capture_hook = hook


def set_amp_hook(hook: Optional[Callable]) -> None:
    """Installed by ``paddle_tpu_torch.amp``: (op_name, arrays) -> arrays."""
    global _amp_hook
    _amp_hook = hook


def amp_cast_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """The type the AMP hook gives an input of op ``name`` that has
    ``dtype`` (``dtype`` itself when no hook casts it)."""
    if _amp_hook is None:
        return dtype
    return _amp_hook(name, (torch.empty(0, dtype=dtype),))[0].dtype


def register_op_impl(name: str, fn: Callable) -> None:
    _op_table[name] = fn


def get_op_impl(name: str, default: Callable) -> Callable:
    return _op_table.get(name, default)


def as_tensor(x: Any, dtype=None, device=None) -> Tensor:
    """An op operand as a Tensor: Python bool / int / float as bool /
    int64 / the default float type, a float64 ndarray as float32 (JAX's
    rules), on ``device`` (the current place when ``None``)."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return wrap_array(x)
    if isinstance(x, np.ndarray) and x.dtype == np.float64 and \
            dtype is None:
        x = x.astype(np.float32)
    return wrap_array(_to_torch(x, dtype, None, device=device))


def unwrap(x: Any):
    return x._data if isinstance(x, Tensor) else x


def _check_nan_inf(name: str, outs) -> None:
    for o in outs:
        if (o.is_floating_point() or o.is_complex()) and \
                not bool(torch.isfinite(o).all()):
            msg = f"NaN/Inf detected in output of op '{name}'"
            if flags.FLAGS_check_nan_inf_level > 0:
                warnings.warn(msg)
            else:
                raise FloatingPointError(msg)


def apply(name: str, fn: Callable, *inputs: Tensor
          ) -> Union[Tensor, tuple]:
    """Run ``fn`` (torch tensors in, one tensor or a tuple out) on the
    inputs' data, cast by the AMP hook when one is installed; torch's
    autograd records it."""
    arrays = tuple(t._data for t in inputs)
    if _amp_hook is not None:
        arrays = _amp_hook(name, arrays)
    outs = fn(*arrays)
    single = not isinstance(outs, (tuple, list))
    outs_t = (outs,) if single else tuple(outs)
    traced = host_reads_forbidden() is not None
    if flags.FLAGS_check_nan_inf and not traced:
        _check_nan_inf(name, outs_t)
    wrapped = tuple(wrap_array(o) for o in outs_t)
    if _capture_hook is not None and not traced:
        if _amp_hook is not None:
            def fn(*arrs, _inner=fn, _hook=_amp_hook):
                return _inner(*_hook(name, arrs))
        _capture_hook(name, fn, inputs, wrapped)
    return wrapped[0] if single else wrapped


def register_kernel_ops() -> None:
    """The port's kernel wrappers under JAX's names."""
    from .flash_attention import flash_attention
    from .fused_adamw import fused_adamw
    from .int8_matmul import int8_matmul
    from .rms_norm import rms_norm
    from .rmsnorm_matmul import rmsnorm_matmul
    from .rope import fused_rope
    from .swiglu import swiglu
    register_op_impl("flash_attention", flash_attention)
    register_op_impl("fused_adamw", fused_adamw)
    register_op_impl("rms_norm", rms_norm)
    register_op_impl("fused_rope", fused_rope)
    register_op_impl("swiglu", swiglu)
    register_op_impl("int8_matmul", int8_matmul)
    register_op_impl("rmsnorm_matmul", rmsnorm_matmul)


register_kernel_ops()
