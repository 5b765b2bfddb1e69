"""The port's runtime flags: a copy of what it needs from
``paddle_tpu/flags.py``.

Flags are typed, initialisable from the environment
(``FLAGS_pallas_swiglu=1 python train.py``) and read by the model code at
call time, so a flag set between two calls changes the second.  The
registry holds only the flags a ported path reads; a slice that needs
another of JAX's flags adds it here.

The three flags below route the LLaMA trunk of
``models/llama_pretrain.py`` through the hand-written kernels that
``paddle_tpu`` ships switched off, on every lane that calls the trunk's
functions (training, packed prefill and paged decode):

* ``FLAGS_pallas_rms_norm``: ``_rms_norm`` (ln1, ln2, the final norm)
  through :func:`ops.rms_norm.rms_norm` when the hidden size is a multiple
  of 128 and the weight is not an int8 dict.
* ``FLAGS_pallas_swiglu``: ``silu(gate) * up`` of the FFN through
  :func:`ops.swiglu.swiglu`, unless ``FLAGS_pallas_rmsnorm_matmul`` takes
  the FFN's entry.
* ``FLAGS_pallas_rmsnorm_matmul``: ln1 + the q / k / v products and ln2 +
  the gate / up products through :func:`ops.rmsnorm_matmul.rmsnorm_matmul`
  for weights that are not int8 dicts.  That branch bypasses the other two
  kernels at those places.
"""

from __future__ import annotations

import os
import sys
import threading
import types
from typing import Any, Dict, List, Union

__all__ = ["define_flag", "get_flags", "set_flags", "flags"]

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off", ""}


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    raise ValueError(f"cannot parse {v!r} as bool")


class _FlagRegistry:
    def __init__(self) -> None:
        self._values: Dict[str, Any] = {}
        self._types: Dict[str, type] = {}
        self._help: Dict[str, str] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any, help: str = "") -> None:
        """Register ``name`` with ``default``; a ``name`` variable in the
        environment sets the first value (one that does not parse is
        ignored, as in JAX's registry)."""
        with self._lock:
            if name in self._values:
                return
            self._values[name] = default
            self._types[name] = type(default)
            self._help[name] = help
        env = os.environ.get(name)
        if env is not None:
            try:
                self.set(name, env)
            except (ValueError, TypeError):
                pass

    def get(self, name: str) -> Any:
        return self._values[name]

    def set(self, name: str, value: Any) -> None:
        if name not in self._values:
            raise ValueError(f"unknown flag {name!r}")
        dtype = self._types[name]
        self._values[name] = (_parse_bool(value) if dtype is bool
                              else dtype(value))

    def known(self) -> List[str]:
        return sorted(self._values)


_registry = _FlagRegistry()


def define_flag(name: str, default: Any, help: str = "") -> None:
    _registry.define(name, default, help)


def get_flags(flags: Union[str, List[str], None] = None) -> Dict[str, Any]:
    """Mirror of ``paddle.get_flags``: every flag, one name or a list."""
    if flags is None:
        names = _registry.known()
    elif isinstance(flags, str):
        names = [flags]
    else:
        names = list(flags)
    return {n: _registry.get(n) for n in names}


def set_flags(flags: Dict[str, Any]) -> None:
    """Mirror of ``paddle.set_flags``; raises on an unknown name."""
    for k, v in flags.items():
        _registry.set(k, v)


class _FlagsView:
    """Attribute access: ``flags.FLAGS_pallas_swiglu``."""

    def __getattr__(self, name: str) -> Any:
        try:
            return _registry.get(name)
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        _registry.set(name, value)


flags = _FlagsView()

define_flag("FLAGS_pallas_rms_norm", False,
            "Route the trunk's rms_norm (ln1, ln2, the final norm) through "
            "the rms_norm kernel when the hidden size is a multiple of 128.")
define_flag("FLAGS_pallas_swiglu", False,
            "Route the FFN's silu(gate) * up through the swiglu kernel.")
define_flag("FLAGS_pallas_rmsnorm_matmul", False,
            "Fuse ln1 into the q / k / v products and ln2 into the gate / "
            "up products through the rmsnorm_matmul kernel.")
define_flag("FLAGS_pallas_flash_attention", True,
            "Route scaled_dot_product_attention through the flash "
            "attention kernels where its rule allows (no mask, no dropout, "
            "q_len == kv_len; bf16 on the card).")
define_flag("FLAGS_pallas_rope", True,
            "Route fused_rotary_position_embedding through the fused RoPE "
            "kernel (rotate-half, no position_ids, head_dim % 128 == 0).")
define_flag("FLAGS_check_nan_inf", False,
            "Check every dispatched op's floating outputs for NaN / Inf.")
define_flag("FLAGS_check_nan_inf_level", 0,
            "0: a NaN / Inf raises FloatingPointError; above 0: it warns.")
define_flag("FLAGS_log_level", 0,
            "VLOG-style verbosity (jit.set_code_level / set_verbosity).")


class _FlagsModule(types.ModuleType):
    """The module itself reads and sets the flags as attributes too
    (``paddle.flags.FLAGS_check_nan_inf``, as JAX's ``paddle.flags``
    view), beside its functions."""

    def __getattr__(self, name: str) -> Any:
        if name.startswith("FLAGS_"):
            return getattr(flags, name)
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("FLAGS_"):
            setattr(flags, name, value)
        else:
            super().__setattr__(name, value)


sys.modules[__name__].__class__ = _FlagsModule
