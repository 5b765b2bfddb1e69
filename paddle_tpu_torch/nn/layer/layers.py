"""nn.Layer and its containers.

Counterpart of ``paddle_tpu/nn/layer/layers.py``: sublayers, parameters,
buffers, forward pre / post hooks, ``state_dict`` / ``set_state_dict``
with JAX's dotted names, ``train`` / ``eval``, ``to`` / ``astype`` /
``bfloat16`` and ``clear_gradients``; ``LayerList``, ``Sequential`` and
``ParameterList``.  Parameters are made on the current place.
``enable_static`` / ``disable_static`` / ``in_dynamic_mode`` keep JAX's
mode flag.

:func:`deferred_init` is the port's own: inside it, ``create_parameter``
makes storage-less ``meta`` tensors, for a caller that sets every
parameter's data itself (``models/weights.py`` builds a LLaMA-7B Layer
model over existing weights that way, without drawing 13 GB first).
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ...framework import dtype as dtypes
from ...framework import place as places
from ...framework.param import Parameter, ParamAttr
from ...tensor.tensor import Tensor, _from_numpy
from .. import initializer as I

__all__ = ["Layer", "LayerList", "Sequential", "ParameterList",
           "deferred_init", "in_dynamic_mode", "enable_static",
           "disable_static"]

_state = threading.local()


_dynamic_mode = [True]


def in_dynamic_mode() -> bool:
    return _dynamic_mode[0]


def enable_static() -> None:
    """Mirror of ``paddle.enable_static``: the mode flag, as JAX's (ops
    still run eagerly; ``paddle.static`` records and replays them)."""
    _dynamic_mode[0] = False


def disable_static() -> None:
    _dynamic_mode[0] = True


@contextlib.contextmanager
def deferred_init():
    """Parameters created inside have no storage (``meta`` tensors) until
    the caller sets their data."""
    prev = getattr(_state, "deferred", False)
    _state.deferred = True
    try:
        yield
    finally:
        _state.deferred = prev


def _rebind(t: Tensor, data: torch.Tensor) -> None:
    """Give ``t`` new data, keeping its ``stop_gradient`` (a parameter stays
    a leaf that requires grad)."""
    keep = t.stop_gradient
    t._data = data.detach()
    t.stop_gradient = keep


class HookRemoveHelper:
    def __init__(self, hooks: dict, hook_id: int):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self) -> None:
        self._hooks.pop(self._hook_id, None)


class Layer:
    """Mirror of ``paddle.nn.Layer``."""

    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        self.training = True
        self._dtype = dtypes.convert_dtype(dtype)
        self._parameters: Dict[str, Parameter] = collections.OrderedDict()
        self._sub_layers: Dict[str, "Layer"] = collections.OrderedDict()
        self._buffers: Dict[str, Tensor] = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks: Dict[int, Callable] = \
            collections.OrderedDict()
        self._forward_post_hooks: Dict[int, Callable] = \
            collections.OrderedDict()
        self._hook_id = [0]
        self._name_scope = name_scope or self.__class__.__name__.lower()

    # -- construction -------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> Optional[Parameter]:
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        dtype = dtype or self._dtype
        if getattr(_state, "deferred", False):
            data = torch.empty(tuple(shape), device="meta",
                               dtype=dtypes.to_torch_dtype(dtype))
        else:
            # the attribute's initializer, else set_global_initializer's,
            # else the layer's default, else the framework's (JAX's order)
            init = attr.initializer or I._global_initializer(is_bias) \
                or default_initializer
            if init is None:
                init = I.Constant(0.0) if is_bias else I.XavierUniform()
            data = init(shape, dtype, places.current_torch_device())
        return Parameter(data, dtype=dtype, name=attr.name,
                         trainable=attr.trainable, attr=attr)

    def add_parameter(self, name: str, parameter: Optional[Parameter]):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name: str, sublayer: "Layer") -> "Layer":
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def register_buffer(self, name: str, tensor: Optional[Tensor],
                        persistable: bool = True) -> None:
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)

    # -- attributes ---------------------------------------------------------
    def __setattr__(self, name: str, value: Any) -> None:
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError(
                    "call super().__init__() before assigning parameters")
            params[name] = value
            if layers is not None:
                layers.pop(name, None)
            if buffers is not None:
                buffers.pop(name, None)
            self.__dict__.pop(name, None)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError(
                    "call super().__init__() before assigning sublayers")
            layers[name] = value
            if params is not None:
                params.pop(name, None)
            self.__dict__.pop(name, None)
        elif buffers is not None and name in buffers:
            buffers[name] = value
        else:
            if params is not None and name in params:
                del params[name]
            if layers is not None and name in layers:
                del layers[name]
            object.__setattr__(self, name, value)

    def __getattr__(self, name: str) -> Any:
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __delattr__(self, name: str) -> None:
        for store in (self._parameters, self._sub_layers, self._buffers):
            if name in store:
                del store[name]
                return
        object.__delattr__(self, name)

    # -- call path ----------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in list(self._forward_pre_hooks.values()):
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in list(self._forward_post_hooks.values()):
            res = hook(self, inputs, outputs)
            if res is not None:
                outputs = res
        return outputs

    def register_forward_pre_hook(self, hook: Callable) -> HookRemoveHelper:
        self._hook_id[0] += 1
        self._forward_pre_hooks[self._hook_id[0]] = hook
        return HookRemoveHelper(self._forward_pre_hooks, self._hook_id[0])

    def register_forward_post_hook(self, hook: Callable) -> HookRemoveHelper:
        self._hook_id[0] += 1
        self._forward_post_hooks[self._hook_id[0]] = hook
        return HookRemoveHelper(self._forward_post_hooks, self._hook_id[0])

    # -- traversal ----------------------------------------------------------
    def children(self) -> Iterator["Layer"]:
        for _, layer in self.named_children():
            yield layer

    def named_children(self) -> Iterator[Tuple[str, "Layer"]]:
        seen = set()
        for name, layer in self._sub_layers.items():
            if layer is not None and id(layer) not in seen:
                seen.add(id(layer))
                yield name, layer

    def sublayers(self, include_self: bool = False) -> List["Layer"]:
        return [layer for _, layer in self.named_sublayers(
            include_self=include_self)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False,
                        layers_set=None) -> Iterator[Tuple[str, "Layer"]]:
        if layers_set is None:
            layers_set = set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, layer in self.named_children():
            if id(layer) in layers_set:
                continue
            yield from layer.named_sublayers(
                prefix=prefix + ("." if prefix else "") + name,
                include_self=True, layers_set=layers_set)

    def _named(self, store: str, prefix: str, include_sublayers: bool):
        seen = set()
        layers = self.named_sublayers(prefix=prefix, include_self=True) \
            if include_sublayers else [(prefix, self)]
        for layer_prefix, layer in layers:
            for name, t in getattr(layer, store).items():
                if t is None or id(t) in seen:
                    continue
                seen.add(id(t))
                yield layer_prefix + ("." if layer_prefix else "") + name, t

    def parameters(self, include_sublayers: bool = True) -> List[Parameter]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True
                         ) -> Iterator[Tuple[str, Parameter]]:
        return self._named("_parameters", prefix, include_sublayers)

    def buffers(self, include_sublayers: bool = True) -> List[Tensor]:
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix: str = "",
                      include_sublayers: bool = True
                      ) -> Iterator[Tuple[str, Tensor]]:
        return self._named("_buffers", prefix, include_sublayers)

    # -- mode / dtype / device ----------------------------------------------
    def train(self) -> "Layer":
        self.training = True
        for layer in self.sublayers():
            layer.training = True
        return self

    def eval(self) -> "Layer":
        self.training = False
        for layer in self.sublayers():
            layer.training = False
        return self

    @torch.no_grad()
    def to(self, device=None, dtype=None, blocking=None) -> "Layer":
        """Move / cast every parameter and buffer (parameters stay
        leaves)."""
        dev = None if device is None else \
            places._parse_device(device).torch_device()
        tdt = dtypes.to_torch_dtype(dtype)
        for _, t in list(self.named_parameters()) + \
                list(self.named_buffers()):
            _rebind(t, t._data.to(device=dev, dtype=tdt))
        if dtype is not None:
            for layer in self.sublayers(include_self=True):
                layer._dtype = dtypes.convert_dtype(dtype)
        return self

    def astype(self, dtype) -> "Layer":
        return self.to(dtype=dtype)

    def bfloat16(self) -> "Layer":
        return self.to(dtype="bfloat16")

    # -- state dict -----------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "",
                   use_hook: bool = True) -> Dict[str, Tensor]:
        out = destination if destination is not None else \
            collections.OrderedDict()
        prefix = structured_name_prefix.rstrip(".")
        for name, p in self.named_parameters(
                prefix=prefix, include_sublayers=include_sublayers):
            out[name] = p
        for name, b in self.named_buffers(
                prefix=prefix, include_sublayers=include_sublayers):
            if name.rsplit(".", 1)[-1] not in \
                    self._non_persistable_buffer_names:
                out[name] = b
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict: Dict[str, Any],
                       use_structured_name: bool = True):
        """Load values by dotted name: Tensors, torch tensors or numpy
        arrays (bf16 ones included), each cast to the parameter's type and
        put on its device.  -> (missing names, unexpected names)."""
        own = self.state_dict()
        missing = []
        for name, t in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            src = state_dict[name]
            if isinstance(src, Tensor):
                src = src._data
            elif not isinstance(src, torch.Tensor):
                src = _from_numpy(np.asarray(src))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{tuple(src.shape)} vs {t.shape}")
            dev = t._data.device
            if dev.type == "meta":
                dev = places.current_torch_device()
            _rebind(t, src.to(device=dev, dtype=t._data.dtype, copy=True))
        unexpected = [k for k in state_dict if k not in own]
        return missing, unexpected

    load_dict = set_state_dict

    def extra_repr(self) -> str:
        return ""

    def __repr__(self) -> str:
        lines = []
        for name, layer in self.named_children():
            body = "\n  ".join(repr(layer).split("\n"))
            lines.append(f"({name}): {body}")
        main = self.__class__.__name__ + "(" + self.extra_repr()
        if lines:
            main += "\n  " + "\n  ".join(lines) + "\n"
        return main + ")"

    def clear_gradients(self) -> None:
        for p in self.parameters():
            p.clear_grad()


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._sub_layers.values())[idx])
        return list(self._sub_layers.values())[idx]

    def __len__(self):
        return len(self._sub_layers)

    def forward(self, x):
        for layer in self._sub_layers.values():
            x = layer(x)
        return x


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or ()):
            self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self.__class__(list(self._sub_layers.values())[idx])
        return self._sub_layers[str(idx % len(self) if idx < 0 else idx)]

    def __setitem__(self, idx, layer):
        self._sub_layers[str(idx)] = layer

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self

    def forward(self, *args, **kwargs):
        raise NotImplementedError("LayerList is a container")


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self
