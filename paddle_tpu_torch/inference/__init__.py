"""paddle.inference: export a model and serve it through a Predictor.

Counterpart of ``paddle_tpu/inference/__init__.py``.  JAX's artifact is a
StableHLO export; the port's is a ``torch.export`` program:

* :func:`convert_to_export` traces a Layer (or a function) once, non-strict,
  at the given input specs, under ``no_grad`` and in eval mode, with host
  reads forbidden (a read raises and names itself), and saves it with
  ``torch.export.save`` as ``path.pt2`` beside ``path.meta.json`` (JAX's
  keys).  A Layer's parameters and buffers go in as the parameters and
  buffers of a wrapping ``torch.nn.Module``, so the artifact carries its
  weights and loads and runs without the model's class.  The port's
  kernels are ``torch.library`` ops (``paddle_tpu_torch::...``), so the
  program names them and runs the kernels on the card; importing this
  module registers every one of them.
* :class:`Predictor` serves that artifact or a ``paddle.jit.save`` bundle
  through the reference's handle API.  On a CUDA device it captures the
  loaded program into a CUDA graph for each input signature
  (``jit.capture.CapturedCall``) and replays it, each call holding the
  graph's lock from its input copy in to its output copy out; a capture
  or a replay that fails raises.  On the CPU the same call runs the
  program eagerly.  Arity and shape
  mismatches raise ``ValueError``; a JAX ``.stablehlo`` file raises too.
  It runs on the card unless the :class:`Config` says ``disable_gpu()``
  or the current place is the CPU (``paddle.set_device("cpu")``).

Nothing here imports the model package, so a process that only serves
needs only the artifact.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import flash_varlen as _flash_varlen  # noqa: F401 (registers K2)
from ..tensor.tensor import Tensor as _PTensor
from ..tensor.tensor import _from_numpy, forbid_host_reads, wrap_array

__all__ = ["Config", "Predictor", "PredictorPool", "Tensor",
           "create_predictor", "convert_to_export", "get_version",
           "PlaceType", "DataType"]

# the file suffix of an exported program (JAX's is ``.stablehlo``)
ARTIFACT_SUFFIX = ".pt2"
_JAX_SUFFIX = ".stablehlo"


def get_version() -> str:
    from .. import __version__
    return __version__


class PlaceType:
    kUNK = -1
    kCPU = 0
    kGPU = 1
    kTPU = 4


class DataType:
    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5
    BFLOAT16 = 6


class Config:
    """Mirror of ``paddle.inference.Config``.  The IR and memory toggles
    are recorded (the port has no IR passes); the device toggles pick
    where the Predictor runs."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if prog_file is not None and params_file is None and \
                os.path.isdir(prog_file):
            self._model_dir = prog_file
            self._prog_file = None
            self._params_file = None
        else:
            self._model_dir = None
            self._prog_file = prog_file
            self._params_file = params_file
        self._use_device: Optional[str] = None    # None: the current place
        self._device_id = 0
        self._memory_optim = True
        self._ir_optim = True
        self._profile = False
        self._num_threads = 1

    # -- model paths ------------------------------------------------------
    def set_model(self, prog_file, params_file=None):
        if params_file is None and os.path.isdir(prog_file):
            self._model_dir = prog_file
        else:
            self._prog_file = prog_file
            self._params_file = params_file

    def set_prog_file(self, path):
        self._prog_file = path

    def set_params_file(self, path):
        self._params_file = path

    def prog_file(self):
        return self._prog_file

    def params_file(self):
        return self._params_file

    def model_dir(self):
        return self._model_dir

    # -- device / optimization toggles -------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_device, self._device_id = "gpu", int(device_id)

    def disable_gpu(self):
        self._use_device = "cpu"

    def enable_xpu(self, *a, **kw):
        self._use_device = "xpu"

    def enable_custom_device(self, device_type="gpu", device_id=0):
        self._use_device, self._device_id = device_type, int(device_id)

    def use_gpu(self):
        return self.device().type == "cuda"

    def device(self) -> torch.device:
        """Where the Predictor runs: the CPU or the card the toggles name,
        else the current place (a device the port lacks is recorded, as
        JAX records it)."""
        if self._use_device == "cpu":
            return torch.device("cpu")
        if self._use_device == "gpu":
            return torch.device("cuda", self._device_id)
        from ..framework.place import current_torch_device
        return current_torch_device()

    def _log_noop(self, knob: str):
        from ..flags import flags
        if flags.FLAGS_log_level >= 1:
            logging.getLogger("paddle_tpu_torch").info(
                "inference.Config.%s: no-op in the port (no IR or memory "
                "passes; the program is replayed as a CUDA graph)", knob)

    def enable_memory_optim(self, x=True):
        self._log_noop("enable_memory_optim")
        self._memory_optim = x

    def switch_ir_optim(self, x=True):
        self._log_noop("switch_ir_optim")
        self._ir_optim = x

    def set_cpu_math_library_num_threads(self, n):
        self._num_threads = n

    def enable_profile(self):
        self._profile = True

    def summary(self) -> str:
        return json.dumps({
            "model_dir": self._model_dir, "prog_file": self._prog_file,
            "params_file": self._params_file,
            "device": self._use_device or "current place",
            "ir_optim": self._ir_optim,
            "memory_optim": self._memory_optim})


class Tensor:
    """Handle-style IO tensor: ``copy_from_cpu(np)`` stages an input,
    ``copy_to_cpu()`` fetches."""

    def __init__(self, name: str):
        self._name = name
        self._value = None

    def name(self):
        return self._name

    def copy_from_cpu(self, arr):
        self._value = np.ascontiguousarray(arr)

    def reshape(self, shape):
        if self._value is not None:
            self._value = self._value.reshape(shape)

    def copy_to_cpu(self):
        return np.asarray(self._value)

    def shape(self):
        return list(self._value.shape) if self._value is not None else []


def _as_input(x) -> torch.Tensor:
    """A port Tensor, a torch tensor or an array-like as a torch tensor
    (numpy's float64 as f32; bf16 arrays kept bf16)."""
    if isinstance(x, _PTensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return _from_numpy(a)


def _spec_tensor(s, device) -> torch.Tensor:
    """An example input for one spec: (shape, dtype), an ``InputSpec``, a
    Tensor or an array."""
    from ..framework import dtype as dtypes
    if isinstance(s, (_PTensor, torch.Tensor, np.ndarray)):
        return _as_input(s).to(device)
    if hasattr(s, "shape") and hasattr(s, "dtype"):
        shape, dtype = s.shape, s.dtype
    else:
        shape, dtype = s
    if any(d is None or (isinstance(d, int) and d < 0) for d in shape):
        raise ValueError(f"convert_to_export takes static shapes, got "
                         f"{tuple(shape)}")
    return torch.zeros(tuple(int(d) for d in shape),
                       dtype=dtypes.to_torch_dtype(str(dtype).replace(
                           "paddle.", "")), device=device)


def _out_data(out) -> List[torch.Tensor]:
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _out_data(o)]
    if isinstance(out, _PTensor):
        return [out._data]
    if isinstance(out, torch.Tensor):
        return [out]
    raise TypeError(f"an exported program returns Tensors, got "
                    f"{type(out).__name__}")


class _LayerModule(torch.nn.Module):
    """A Layer as a ``torch.nn.Module``: its parameters and buffers are
    this module's, swapped into the Layer for the call (what an export
    traces)."""

    def __init__(self, layer):
        super().__init__()
        self._layer = [layer]            # not a submodule
        self._targets = []
        for name, p in layer.named_parameters():
            self.register_parameter(name.replace(".", "__"),
                                    torch.nn.Parameter(p._data.detach(),
                                                       requires_grad=False))
            self._targets.append(p)
        for name, b in layer.named_buffers():
            self.register_buffer("buf__" + name.replace(".", "__"),
                                 b._data.detach())
            self._targets.append(b)

    def forward(self, *xs):
        news = list(self.parameters()) + list(self.buffers())
        saved = [t._data for t in self._targets]
        try:
            for t, new in zip(self._targets, news):
                t._data = new
            out = self._layer[0](*[wrap_array(x) for x in xs])
        finally:
            for t, old in zip(self._targets, saved):
                t._data = old
        return tuple(_out_data(out))


class _FnModule(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self._fn = [fn]

    def forward(self, *xs):
        return tuple(_out_data(self._fn[0](*[wrap_array(x) for x in xs])))


def convert_to_export(layer_or_fn, input_spec: Sequence, path: str,
                      platforms: Optional[Sequence[str]] = None) -> str:
    """Export to ``path.pt2`` (a ``torch.export`` program with the weights)
    and ``path.meta.json``; returns the ``.pt2`` path.  ``input_spec``: a
    list of (shape, dtype), ``InputSpec`` s, Tensors or arrays.  The
    program runs on the device the Layer's parameters are on (the current
    place for a function)."""
    from ..jit import inner_layer
    from ..nn.layer.layers import Layer
    layer_or_fn = inner_layer(layer_or_fn)
    was_training = None
    if isinstance(layer_or_fn, Layer):
        params = layer_or_fn.parameters() + layer_or_fn.buffers()
        if params:
            device = params[0]._data.device
        else:
            from ..framework.place import current_torch_device
            device = current_torch_device()
        module = _LayerModule(layer_or_fn)
        was_training = layer_or_fn.training
        layer_or_fn.eval()
    else:
        from ..framework.place import current_torch_device
        device = current_torch_device()
        module = _FnModule(layer_or_fn)
    examples = tuple(_spec_tensor(s, device) for s in input_spec)
    try:
        with torch.no_grad(), \
                forbid_host_reads("inference.convert_to_export"):
            ep = torch.export.export(module, examples, strict=False)
    finally:
        if was_training:
            layer_or_fn.train()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    torch.export.save(ep, path + ARTIFACT_SUFFIX)
    with open(path + ".meta.json", "w") as f:
        json.dump({"n_inputs": len(examples),
                   "n_outputs": len(ep.graph_signature.user_outputs),
                   "input_shapes": [list(x.shape) for x in examples],
                   "input_dtypes": [str(x.dtype).replace("torch.", "")
                                    for x in examples],
                   "format": "torch.export", "device": device.type}, f)
    return path + ARTIFACT_SUFFIX


class Predictor:
    """Mirror of ``paddle.inference.Predictor``: serves an exported
    program (``Config(prog_file='x.pt2')``) or a ``paddle.jit.save``
    bundle, one CUDA graph per input signature on the card."""

    def __init__(self, config: Config, _shared_from=None, device=None):
        self._config = config
        self._device = torch.device(device) if device is not None \
            else config.device()
        self._inputs: Dict[str, Tensor] = {}
        self._outputs: List[np.ndarray] = []
        # input signature -> CapturedCall (the card's programs)
        self._calls: Dict[tuple, object] = {}
        self._build_lock = threading.Lock()
        if _shared_from is not None:
            src = _shared_from
            self._module, self._layer = src._module, src._layer
            self._meta = src._meta
            if src._device == self._device:
                self._calls, self._build_lock = src._calls, src._build_lock
            elif self._module is not None:
                self._module = copy.deepcopy(src._module).to(self._device)
        else:
            self._module, self._layer, self._meta = None, None, None
            self._load()

    def _load(self):
        prog = self._config.prog_file()
        if prog and prog.endswith(_JAX_SUFFIX):
            raise ValueError(
                f"{prog} is JAX's StableHLO export (paddle_tpu.inference."
                f"convert_to_export); the port serves torch.export programs "
                f"({ARTIFACT_SUFFIX}): export the model again with "
                f"paddle_tpu_torch.inference.convert_to_export")
        if prog and prog.endswith(ARTIFACT_SUFFIX):
            ep = torch.export.load(prog)
            self._module = ep.module().to(self._device)
            meta_path = prog[:-len(ARTIFACT_SUFFIX)] + ".meta.json"
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    self._meta = json.load(f)
            else:
                n = len(ep.graph_signature.user_inputs)
                self._meta = {"n_inputs": n, "n_outputs": len(
                    ep.graph_signature.user_outputs)}
            return
        # a paddle.jit.save bundle
        base = prog
        if base and base.endswith(".pdmodel"):
            base = base[:-len(".pdmodel")]
        if base is None and self._config.model_dir():
            base = os.path.join(self._config.model_dir(), "inference")
        from .. import jit as pjit
        self._layer = pjit.load(base).to(device=self._device)
        self._layer.eval()

    @property
    def _n_inputs(self):
        return self._meta["n_inputs"] if self._meta else 1

    # -- reference handle API --------------------------------------------
    def get_input_names(self):
        return [f"x{i}" for i in range(self._n_inputs)]

    def get_input_handle(self, name) -> Tensor:
        return self._inputs.setdefault(name, Tensor(name))

    def get_output_names(self):
        n = self._meta["n_outputs"] if self._meta else \
            (len(self._outputs) or 1)
        return [f"out{i}" for i in range(n)]

    def get_output_handle(self, name) -> Tensor:
        t = Tensor(name)
        idx = int(name.replace("out", "") or 0)
        if idx < len(self._outputs):
            t._value = self._outputs[idx]
        return t

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """With ``inputs``: the functional form, returns a list of numpy
        arrays.  Without: consumes the staged input handles."""
        functional = inputs is not None
        if inputs is None:
            # numeric order: sorted() would put x10 before x2
            names = sorted(self._inputs,
                           key=lambda n: int(n.lstrip("x") or 0)
                           if n.lstrip("x").isdigit() else n)
            inputs = [self._inputs[n].copy_to_cpu() for n in names]
        outs = self._execute(inputs)
        self._outputs = outs
        return self._outputs if functional else None

    def _inputs_of(self, inputs) -> List[torch.Tensor]:
        """The inputs on the predictor's device, checked against the
        exported signature (arity, shapes) and cast to its types."""
        from ..framework import dtype as dtypes
        xs = [_as_input(x) for x in inputs]
        meta = self._meta
        if meta is not None:
            if meta["n_inputs"] != len(xs):
                raise ValueError(f"predictor expects {meta['n_inputs']} "
                                 f"inputs, got {len(xs)}")
            for i, (x, shape) in enumerate(zip(
                    xs, meta.get("input_shapes", [None] * len(xs)))):
                if shape is not None and list(x.shape) != list(shape):
                    raise ValueError(
                        f"input {i} has shape {list(x.shape)}, the exported "
                        f"program takes {shape}")
            xs = [x.to(dtypes.to_torch_dtype(t)) for x, t in zip(
                xs, meta.get("input_dtypes", [None] * len(xs)))]
        return [x.to(self._device) for x in xs]

    def _forward(self, *xs) -> List[torch.Tensor]:
        if self._module is not None:
            out = self._module(*xs)
            return list(out) if isinstance(out, (list, tuple)) else [out]
        return _out_data(self._layer(*[wrap_array(x) for x in xs]))

    def _call_for(self, xs: Sequence[torch.Tensor]):
        """The call of ``xs``' signature (on the card its CUDA graph),
        made at its first use."""
        from ..jit.capture import CapturedCall
        key = tuple((tuple(x.shape), x.dtype) for x in xs)
        call = self._calls.get(key)
        if call is None:
            with self._build_lock:
                call = self._calls.get(key)
                if call is None:
                    with torch.no_grad():
                        call = CapturedCall(self._forward, xs)
                    self._calls[key] = call
        return call

    def _execute(self, inputs) -> List[np.ndarray]:
        """The stateless form (what concurrent callers use)."""
        xs = self._inputs_of(inputs)
        with torch.no_grad():
            outs = self._call_for(xs).run(xs)
        return [wrap_array(o).numpy() for o in outs]

    def clear_intermediate_tensor(self):
        pass

    def try_shrink_memory(self):
        pass


class PredictorPool:
    """Mirror of ``paddle.inference.PredictorPool``: predictors sharing one
    loaded program, and on one device its captured graphs (each graph's
    lock keeps concurrent callers apart)."""

    def __init__(self, config: Config, size: int = 1):
        first = Predictor(config)
        self._predictors = [first] + [
            Predictor(config, _shared_from=first)
            for _ in range(size - 1)]

    def retrieve(self, idx: int) -> Predictor:
        return self._predictors[idx]


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
