"""paddle.jit: ``to_static``, ``save`` / ``load``.

Counterpart of ``paddle_tpu/jit/__init__.py``.  JAX wraps a Layer (or a
function) in one ``jax.jit`` program per signature.  The port keeps JAX's
semantics and builds the program its own way:

* the key of a signature holds the train / eval mode, the non-Tensor
  arguments (by value: JAX's ``_static_key_of``), the Tensor arguments'
  shapes, types, devices and ``stop_gradient``, the parameters' and
  buffers' addresses (storage rebound by ``set_state_dict`` captures
  anew), grad mode, the AMP state and the port's flags;
* the first call of a signature runs the dy2static-converted function
  (on the card: the capture's warm-up run) under
  ``tensor.forbid_host_reads``, where a host read of a Tensor
  (``bool``, ``item``, ``numpy``, ``float``, ``int``, ``tolist``) raises
  as a JAX tracer does.  Only such a graph break falls back: with
  ``full_graph=False`` the key runs the original function eagerly from
  then on, with JAX's one ``RuntimeWarning`` ("running eagerly") for it;
  with ``full_graph=True`` it raises.  A converted ``while`` on a device
  predicate (``dy2static.DeviceLoop``) runs its key eagerly, without a
  warning (ROADMAP.md queue 3);
* on a CUDA device each key is then captured into CUDA graphs
  (``jit.capture``): one forward graph, and a backward graph when grad
  is on and an input or a parameter needs it, the framework's generator
  registered, so dropout draws a fresh mask every replay and the same
  masks after the same ``paddle.seed``.  A capture or a replay that fails
  raises;
* on the CPU the converted function runs eagerly, because the caller
  chose that device;
* parameters are read live (at their addresses), so an optimizer's update
  between calls is seen; buffers are left as they were, as JAX's pure
  program leaves them.

``save`` writes ``path.pdiparams`` with ``paddle.save`` (JAX's format, so
a file from either package loads into a Layer of the same class in the
other) and ``path.pdmodel``, a pickle of the Layer; ``load`` returns a
:class:`TranslatedLayer`.
"""

from __future__ import annotations

import functools
import hashlib
import pickle
import types
import warnings
import weakref
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..nn.layer.layers import Layer
from ..tensor.tensor import (HostReadError, Tensor, forbid_host_reads,
                             host_reads_forbidden, wrap_array)
from .dy2static import DeviceLoop, _flatten, ast_transform

__all__ = ["to_static", "not_to_static", "ignore_module", "save", "load",
           "set_code_level", "set_verbosity",
           "TranslatedLayer", "InputSpec", "enable_to_static"]

_to_static_enabled = [True]


def enable_to_static(flag: bool) -> None:
    _to_static_enabled[0] = bool(flag)


_ADDR_REPR_WARNED: set = set()
# ndarray content digests are O(bytes) to compute; memoised per live
# object (identity checked through a weakref)
_DIGEST_MEMO: Dict[int, Tuple[Any, str, bytes]] = {}


def _ndarray_sample(v: np.ndarray) -> bytes:
    """Content fingerprint guarding the digest memo against in-place
    mutation: the full bytes up to 64 KB, else a 64-point stride sample
    and the adler32 of the whole array."""
    flat = v.reshape(-1)
    if flat.size == 0:
        return b""
    if v.nbytes <= 65536:
        return np.ascontiguousarray(flat).tobytes()
    sample = np.ascontiguousarray(
        flat[::max(1, flat.size // 64)]).tobytes()
    try:
        chk = zlib.adler32(np.ascontiguousarray(v)).to_bytes(4, "little")
    except (TypeError, ValueError, BufferError):    # object arrays
        chk = b""
    return sample + chk


def _ndarray_digest(v: np.ndarray) -> str:
    hit = _DIGEST_MEMO.get(id(v))
    if hit is not None and hit[0]() is v and hit[2] == _ndarray_sample(v):
        return hit[1]
    d = hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
    try:
        _DIGEST_MEMO[id(v)] = (weakref.ref(v), d, _ndarray_sample(v))
    except TypeError:
        pass
    if len(_DIGEST_MEMO) > 4096:    # drop dead entries, bound growth
        for k in [k for k, e in _DIGEST_MEMO.items() if e[0]() is None]:
            del _DIGEST_MEMO[k]
    return d


def _static_key_of(v) -> Any:
    """Value-stable hashable key for a non-Tensor argument (JAX's):
    containers recursed, arrays by content, an address-bearing repr by
    identity with one warning per type."""
    if isinstance(v, np.ndarray):
        return ("ndarray", str(v.dtype), v.shape, _ndarray_digest(v))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__,) + tuple(_static_key_of(e) for e in v)
    if isinstance(v, dict):
        return ("dict",) + tuple(sorted(
            ((_static_key_of(k), _static_key_of(e))
             for k, e in v.items()), key=repr))
    if isinstance(v, (set, frozenset)):
        return (type(v).__name__, tuple(sorted(
            (_static_key_of(e) for e in v), key=repr)))
    r = repr(v)
    if " at 0x" in r:
        tname = type(v).__name__
        if tname not in _ADDR_REPR_WARNED:
            _ADDR_REPR_WARNED.add(tname)
            warnings.warn(
                f"to_static: static argument of type {tname!r} has an "
                "address-bearing repr; it is keyed by identity, so every "
                "new instance re-traces.  Pass a value-stable object (or "
                "a Tensor) instead.", stacklevel=3)
        return ("id", tname, id(v))
    return r


class InputSpec:
    """Mirror of ``paddle.static.InputSpec``."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


def _amp_key():
    from ..amp import _state
    return (_state.enabled, _state.level, _state.dtype,
            tuple(sorted(_state.white)), tuple(sorted(_state.black)))


class StaticFunction:
    """The compiled wrapper around a Layer or a function."""

    def __init__(self, obj, input_spec=None, build_strategy=None,
                 full_graph=False, backend=None):
        self._obj = obj
        self._input_spec = input_spec
        self._full_graph = full_graph
        # key -> CapturedCall / GradCall (the card's programs)
        self._calls: Dict[Any, Any] = {}
        self._out_trees: Dict[Any, Any] = {}
        self._checked: set = set()
        self._fallback_keys: set = set()
        self._eager_keys: set = set()
        functools.update_wrapper(
            self, obj.forward if isinstance(obj, Layer) else obj)
        # the converted forward is swapped in only while this wrapper runs
        # it; the original stays the eager target of a graph break
        if isinstance(obj, Layer):
            self._converted_method = ast_transform(type(obj).forward)
            self._converted = None
        else:
            self._converted_method = None
            self._converted = ast_transform(obj)

    @property
    def _layer(self) -> Optional[Layer]:
        return self._obj if isinstance(self._obj, Layer) else None

    def _state_tensors(self):
        """The parameters' and buffers' data the call reads."""
        layer = self._layer
        if layer is None:
            return [], []
        return ([p._data for p in layer.parameters()],
                [b._data for b in layer.buffers()])

    def _key(self, args, kwargs):
        from ..flags import get_flags
        layer = self._layer
        params, bufs = self._state_tensors()
        tensors = [a for a in args if isinstance(a, Tensor)] + \
            [kwargs[k] for k in sorted(kwargs) if isinstance(kwargs[k],
                                                             Tensor)]
        return (layer.training if layer is not None else None,
                tuple(sorted((k, _static_key_of(v)) for k, v in
                             kwargs.items() if not isinstance(v, Tensor))),
                tuple(sorted(k for k, v in kwargs.items()
                             if isinstance(v, Tensor))),
                tuple("·" if isinstance(a, Tensor) else _static_key_of(a)
                      for a in args),
                tuple((tuple(t._data.shape), t._data.dtype,
                       str(t._data.device), t._data.requires_grad)
                      for t in tensors),
                tuple((p.data_ptr(), p.requires_grad) for p in params),
                tuple(b.data_ptr() for b in bufs),
                torch.is_grad_enabled(), _amp_key(),
                tuple(sorted(get_flags().items())))

    def _run(self, args, kwargs):
        """The converted function (or forward), buffers left as they
        were."""
        layer = self._layer
        if layer is None:
            return (self._converted or self._obj)(*args, **kwargs)
        kept = [(sub, name, b) for sub in layer.sublayers(include_self=True)
                for name, b in sub._buffers.items()]
        datas = [b._data if b is not None else None for _, _, b in kept]
        conv = self._converted_method
        orig = layer.__dict__.get("forward")
        if conv is not None:
            object.__setattr__(layer, "forward",
                               types.MethodType(conv, layer))
        try:
            return layer(*args, **kwargs)
        finally:
            if conv is not None:
                if orig is None:
                    del layer.__dict__["forward"]
                else:
                    object.__setattr__(layer, "forward", orig)
            for (sub, name, b), d in zip(kept, datas):
                sub._buffers[name] = b
                if b is not None:
                    b._data = d

    def _graph_break(self, key, err, args, kwargs):
        if self._full_graph:
            raise err
        self._fallback_keys.add(key)
        warnings.warn(
            f"to_static({getattr(self, '__name__', '?')}): whole-graph "
            f"tracing failed ({type(err).__name__}: {str(err)[:200]}); "
            f"running eagerly.  Data-dependent Python control flow that the "
            f"dy2static pass could not convert is the usual cause; pass "
            f"full_graph=True to make this an error", RuntimeWarning,
            stacklevel=3)
        return self._obj(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        if not _to_static_enabled[0]:
            return self._obj(*args, **kwargs)
        device = self._device(args, kwargs)
        if host_reads_forbidden() is not None or (
                device.type == "cuda" and
                torch.cuda.is_current_stream_capturing()):
            # inside an outer program (a capture, an export): inline
            return self._run(args, kwargs)
        key = self._key(args, kwargs)
        if key in self._fallback_keys:
            return self._obj(*args, **kwargs)
        if key in self._eager_keys:
            return self._run(args, kwargs)
        if key not in self._checked:
            # the checked run: on the card the capture's warm-up run (host
            # reads forbidden there too), so no eager graph of this call
            # outlives it into the capture
            try:
                if device.type == "cuda":
                    out = self._replay(key, device, args, kwargs)
                else:
                    with forbid_host_reads("jit.to_static"):
                        out = self._run(args, kwargs)
            except HostReadError as e:
                return self._graph_break(key, e, args, kwargs)
            except DeviceLoop:
                self._eager_keys.add(key)
                return self._run(args, kwargs)
            self._checked.add(key)
            return out
        if device.type != "cuda":
            return self._run(args, kwargs)
        return self._replay(key, device, args, kwargs)

    def _device(self, args, kwargs):
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, Tensor):
                return a._data.device
        params, bufs = self._state_tensors()
        for t in params + bufs:
            return t.device
        return torch.device("cpu")

    def _replay(self, key, device, args, kwargs):
        from ..framework import random as framework_random
        from .capture import CapturedCall, GradCall
        pos = [i for i, a in enumerate(args) if isinstance(a, Tensor)]
        names = sorted(k for k, v in kwargs.items() if isinstance(v, Tensor))
        tensors = [args[i]._data for i in pos] + \
            [kwargs[k]._data for k in names]
        call = self._calls.get(key)
        if call is None:
            def fn(*arrs):
                a = list(args)
                for i, arr in zip(pos, arrs):
                    a[i] = wrap_array(arr)
                kw = dict(kwargs)
                for k, arr in zip(names, arrs[len(pos):]):
                    kw[k] = wrap_array(arr)
                leaves, rebuild = _flatten(self._run(a, kw))
                self._out_trees[key] = (rebuild, [
                    None if isinstance(x, Tensor) else x for x in leaves])
                return [x._data for x in leaves if isinstance(x, Tensor)]

            params, _ = self._state_tensors()
            gen = framework_random.generator(device)
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in tensors + params):
                call = GradCall(fn, tensors, params, gen)
            else:
                call = CapturedCall(fn, tensors, gen)
            self._calls[key] = call
        outs = iter(call.run(tensors))
        rebuild, consts = self._out_trees[key]
        return rebuild(iter([wrap_array(next(outs)) if c is None else c
                             for c in consts]))

    # parity helpers
    def concrete_program(self):
        return self

    @property
    def program_cache(self):
        return self._calls


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=False, **kwargs):
    """Mirror of ``paddle.jit.to_static``: a Layer comes back as a Layer
    whose forward runs through the compiled wrapper, a function as a
    :class:`StaticFunction`."""

    def decorate(obj):
        if isinstance(obj, Layer):
            wrapper = StaticFunction(obj, input_spec, build_strategy,
                                     full_graph, backend)
            object.__setattr__(obj, "forward_static", wrapper)
            return _StaticLayerProxy(obj, wrapper)
        return StaticFunction(obj, input_spec, build_strategy, full_graph,
                              backend)

    if function is not None:
        return decorate(function)
    return decorate


class _StaticLayerProxy(Layer):
    """Layer whose forward runs through the compiled wrapper but which
    otherwise behaves as the original (parameters, state_dict, ...)."""

    def __init__(self, inner: Layer, static_fn: StaticFunction):
        super().__init__()
        self.add_sublayer("_inner", inner)
        object.__setattr__(self, "_static_fn", static_fn)

    def forward(self, *args, **kwargs):
        return self._static_fn(*args, **kwargs)

    def state_dict(self, *a, **kw):
        return self._sub_layers["_inner"].state_dict(*a, **kw)

    def set_state_dict(self, *a, **kw):
        return self._sub_layers["_inner"].set_state_dict(*a, **kw)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._sub_layers["_inner"], name)


def inner_layer(layer):
    """The Layer a ``to_static`` proxy wraps (``layer`` itself
    otherwise)."""
    if isinstance(layer, _StaticLayerProxy):
        return layer._sub_layers["_inner"]
    return layer


def not_to_static(func):
    func._not_to_static = True
    return func


def ignore_module(modules):
    pass


def save(layer, path, input_spec=None, **configs):
    """Mirror of ``paddle.jit.save``: ``path.pdiparams`` (the state_dict,
    ``paddle.save``'s format) and ``path.pdmodel`` (a pickle of the Layer
    and its meta); ``load`` restores a callable :class:`TranslatedLayer`."""
    import os
    d = os.path.dirname(str(path))
    if d:
        os.makedirs(d, exist_ok=True)
    from ..framework.io import save as fsave
    target = inner_layer(layer)
    state = target.state_dict() if isinstance(target, Layer) else {}
    fsave(state, str(path) + ".pdiparams")
    meta = {"class_module": type(target).__module__,
            "class_name": type(target).__qualname__,
            "input_spec": input_spec}
    # the compiled wrapper (converted code, graphs) is not part of the model
    wrapper = target.__dict__.pop("forward_static", None) \
        if isinstance(target, Layer) else None
    try:
        blob = pickle.dumps({"meta": meta, "layer": target})
    except Exception:
        blob = pickle.dumps({"meta": meta, "layer": None})
    finally:
        if wrapper is not None:
            object.__setattr__(target, "forward_static", wrapper)
    with open(str(path) + ".pdmodel", "wb") as f:
        f.write(blob)


class TranslatedLayer(Layer):
    def __init__(self, inner: Layer):
        super().__init__()
        self.add_sublayer("_inner", inner)

    def forward(self, *args, **kwargs):
        return self._sub_layers["_inner"](*args, **kwargs)


def load(path, **configs):
    """Mirror of ``paddle.jit.load``."""
    from ..framework.io import load as fload
    with open(str(path) + ".pdmodel", "rb") as f:
        blob = pickle.load(f)
    layer = blob.get("layer")
    if layer is None:
        raise RuntimeError(
            f"{path}.pdmodel does not contain a loadable layer (the class "
            "was not importable at save time)")
    state = fload(str(path) + ".pdiparams")
    layer.set_state_dict(state)
    return TranslatedLayer(layer)


def set_code_level(level=100, also_to_stdout=False):
    """Sets ``FLAGS_log_level``, the framework's diagnostic verbosity (as
    JAX's)."""
    from ..flags import flags
    flags.FLAGS_log_level = level


def set_verbosity(level=0, also_to_stdout=False):
    from ..flags import flags
    flags.FLAGS_log_level = level
