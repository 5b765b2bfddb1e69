"""AMP: ``auto_cast``, ``decorate`` and ``GradScaler``.

Counterpart of ``paddle_tpu/amp/__init__.py``.  The cast policy is a hook
on the op dispatch (``ops/dispatch.set_amp_hook``), installed once at
import and gated by a thread-local state, so each thread's ``auto_cast``
is its own:

* O1: an op of the white list (the matmul / attention set) casts its
  floating inputs to the low type, an op of the black list (reductions,
  norms, losses) to f32, every other op ("gray") leaves its inputs as they
  are, so that bf16 + f32 promotes to f32 as in JAX;
* O2: every op but the black list runs in the low type;
* ``custom_white_list`` / ``custom_black_list`` add op names to the lists
  of the context (a custom black entry takes an op off the white list).

The op names are JAX's (``"linear"``, ``"sdpa"``, ``"flash_attention"``,
``"layer_norm"``, ``"softmax"``, ``"cross_entropy"`` ...), so the same
lists reach the same ops.  ``decorate(level="O2")`` casts f32 parameters
to the low type, LayerNorm's excepted, and sets the optimizers'
``multi_precision``.  ``GradScaler`` is dynamic loss scaling with one
fused finite check and one host read an ``unscale_``.  ``amp.debugging``
is not ported yet (ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Set

import torch

from ..ops import dispatch as _dispatch
from ..tensor.tensor import Tensor, wrap_array

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "is_float16_supported", "is_bfloat16_supported", "AmpScaler",
           "white_list", "black_list", "is_auto_cast_enabled",
           "get_amp_dtype"]

WHITE_LIST: Set[str] = {
    "matmul", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "sdpa", "flash_attention", "addmm", "mm",
}
BLACK_LIST: Set[str] = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "mean", "sum",
    "softmax", "log_softmax", "cross_entropy", "nll_loss", "l1_loss",
    "mse_loss", "binary_cross_entropy", "bce_with_logits", "kl_div",
    "layer_norm", "batch_norm", "instance_norm", "group_norm", "rms_norm",
    "norm", "cumsum", "cumprod", "var", "std", "erf", "erfinv", "pow",
    "divide", "sigmoid_focal_loss", "softmax_with_cross_entropy",
}
_FLOATS = (torch.float32, torch.float16, torch.bfloat16)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = "bfloat16"
        self.level = "O1"
        self.white = set()
        self.black = set()


_state = _AmpState()


def is_auto_cast_enabled() -> bool:
    return _state.enabled


def get_amp_dtype() -> str:
    return _state.dtype


def white_list():
    return {"float16": WHITE_LIST, "bfloat16": WHITE_LIST}


def black_list():
    return {"float16": BLACK_LIST, "bfloat16": BLACK_LIST}


def _target(op_name: str):
    """The type op ``op_name`` casts its floating inputs to under the
    current state, or None (leave them)."""
    low = torch.bfloat16 if _state.dtype == "bfloat16" else torch.float16
    if _state.level == "O2":
        if op_name in BLACK_LIST or op_name in _state.black:
            return torch.float32
        return low
    if op_name in _state.white or (op_name in WHITE_LIST and
                                   op_name not in _state.black):
        return low
    if op_name in BLACK_LIST or op_name in _state.black:
        return torch.float32
    return None


def _amp_hook(op_name: str, arrays):
    """Called by ``ops.dispatch.apply`` before the op runs."""
    if not _state.enabled:
        return arrays
    target = _target(op_name)
    if target is None:
        return arrays
    return tuple(a.to(target) if a.dtype in _FLOATS and a.dtype != target
                 else a for a in arrays)


class auto_cast:
    """Mirror of ``paddle.amp.auto_cast`` (a context manager)."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        if dtype not in ("bfloat16", "float16", "float32"):
            raise ValueError(
                f"auto_cast dtype must be bfloat16/float16/float32, got "
                f"{dtype!r}")
        if level not in ("O0", "O1", "O2"):
            raise ValueError(f"auto_cast level must be O0/O1/O2, got "
                             f"{level!r}")
        if level == "O0" or dtype == "float32":
            enable = False
        self._cfg = (enable, set(custom_white_list or ()),
                     set(custom_black_list or ()), level, dtype)

    def __enter__(self):
        self._prev = (_state.enabled, _state.white, _state.black,
                      _state.level, _state.dtype)
        (_state.enabled, _state.white, _state.black, _state.level,
         _state.dtype) = self._cfg
        return self

    def __exit__(self, *exc):
        (_state.enabled, _state.white, _state.black, _state.level,
         _state.dtype) = self._prev
        return False


_dispatch.set_amp_hook(_amp_hook)

amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2 casts every f32 parameter to the low type, except LayerNorm's
    and ``excluded_layers``' (instances or classes), and turns on the
    optimizers' ``multi_precision`` (f32 master copies)."""
    from ..nn.layer.layers import _rebind
    from ..nn.layer.norm import LayerNorm
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        low = torch.bfloat16 if dtype == "bfloat16" else torch.float16
        exc = excluded_layers or []
        exc = exc if isinstance(exc, (list, tuple)) else [exc]
        for m in model_list:
            excluded = set()
            for sub in m.sublayers(include_self=True):
                if isinstance(sub, LayerNorm) or any(
                        (isinstance(e, type) and isinstance(sub, e)) or
                        sub is e for e in exc):
                    excluded.update(id(p) for p in sub.parameters())
            with torch.no_grad():
                for p in m.parameters():
                    if id(p) not in excluded and \
                            p._data.dtype == torch.float32:
                        _rebind(p, p._data.to(low))
    if optimizers is None:
        return models if single_model else model_list
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    if level == "O2":
        for o in opt_list:
            o._multi_precision = True
    return (models if single_model else model_list,
            optimizers if single_opt else opt_list)


class GradScaler:
    """Dynamic loss scaling (JAX's ``GradScaler``, step for step)."""

    def __init__(self, enable=True, init_loss_scaling=65536.0,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def scale(self, var: Tensor) -> Tensor:
        if not self._enable:
            return var
        from ..tensor.math import multiply
        return multiply(var, float(self._scale))

    @torch.no_grad()
    def unscale_(self, optimizer) -> None:
        """Every gradient times 1 / scale, then one reduction of their
        finite flags and one host read."""
        if not self._enable or self._unscaled:
            return
        inv = 1.0 / self._scale
        flags = []
        for p in optimizer._params():
            g = p._data.grad
            if g is not None:
                g = g * inv
                flags.append(torch.isfinite(g).all())
                p._data.grad = g
        self._found_inf = bool(flags) and not bool(torch.stack(flags).all())
        self._unscaled = True

    def step(self, optimizer) -> None:
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self) -> None:
        if not self._enable:
            return
        if self._dynamic:
            if self._found_inf:
                self._bad_steps += 1
                self._good_steps = 0
                if self._bad_steps >= self._decr_every:
                    self._scale = max(self._scale * self._decr_ratio, 1.0)
                    self._bad_steps = 0
            else:
                self._good_steps += 1
                self._bad_steps = 0
                if self._good_steps >= self._incr_every:
                    self._scale *= self._incr_ratio
                    self._good_steps = 0
        self._found_inf = False
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss) -> None:
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def state_dict(self) -> Dict[str, Any]:
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps,
                "use_dynamic_loss_scaling": self._dynamic}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)

    def get_loss_scaling(self):
        from ..framework.place import current_torch_device
        return wrap_array(torch.tensor(self._scale, dtype=torch.float32,
                                       device=current_torch_device()))

    def set_init_loss_scaling(self, v):
        self._scale = float(v)


AmpScaler = GradScaler


def is_float16_supported(device=None):
    """fp16 compute on the place: every CUDA card the port runs on; the
    CPU's plain versions take it too."""
    return True


def is_bfloat16_supported(device=None):
    """bf16 compute: Hopper's native training type (and the CPU's)."""
    from ..framework.place import _parse_device, current_torch_device
    dev = current_torch_device() if device is None else \
        _parse_device(device).torch_device()
    if dev.type == "cuda":
        return torch.cuda.is_bf16_supported()
    return True
