"""paddle.static: the static-graph compatibility layer.

Counterpart of ``paddle_tpu/static/__init__.py``.  A :class:`Program`
records, while it is active under :func:`program_guard`, every op whose
inputs derive from a :func:`data` placeholder, through the capture hook
of ``ops/dispatch.py`` (JAX's ``set_capture_hook``); ops run eagerly too,
so mixed eager / static code behaves.  :class:`Executor` runs the
recorded ops again with a feed: on a CUDA device it captures them once per
(program version, fetch set, feed signature, the live tensors' addresses)
into a CUDA graph (``jit.capture``) and replays it; on the CPU it runs
them eagerly.  Parameters are read live at each run, so an update between
runs is seen (a parameter rebound to new storage, ``set_value``, captures
anew).

``save_inference_model`` / ``load_inference_model`` and
``serialize_program`` / ``deserialize_program`` go through
``inference.convert_to_export`` (a ``torch.export`` program, the port's
artifact where JAX writes StableHLO); the persistables pair pickles the
state_dict as numpy arrays, as JAX's does.
"""

from __future__ import annotations

import contextlib
import io
import os
import pickle
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..framework.place import CPUPlace, CUDAPlace, Place
from ..jit import InputSpec  # noqa: F401 (public alias paddle.static.InputSpec)
from ..tensor.tensor import Tensor, _to_torch, to_tensor, wrap_array

__all__ = ["Program", "program_guard", "default_main_program",
           "default_startup_program", "Executor", "data", "InputSpec",
           "name_scope", "global_scope", "scope_guard", "cpu_places",
           "device_guard", "save_inference_model", "load_inference_model",
           "gradients", "append_backward", "nn"]


class Variable(Tensor):
    pass


class Program:
    """A captured computation graph: ``(fn, input slots, output slots)``
    for each op that read a placeholder or an op's output, the feeds'
    slots, and the live tensors (parameters, constants) the ops read."""

    def __init__(self):
        self.ops: List = []                       # (fn, in_slots, out_slots)
        self._feed_targets: Dict[str, Any] = {}
        self._feed_slots: Dict[str, int] = {}     # name -> slot id
        self._slot_of: Dict[int, int] = {}        # id(Tensor) -> slot
        self._slot_const: Dict[int, Any] = {}     # slot -> live Tensor
        self._keepalive: List = []   # pin captured tensors: id() reuse
        self._next_slot = 0
        self._version = 0
        self.random_seed = 0

    # -- capture ---------------------------------------------------------
    def _slot_for(self, t) -> int:
        slot = self._slot_of.get(id(t))
        if slot is None:
            slot = self._next_slot
            self._next_slot += 1
            self._slot_of[id(t)] = slot
            # not produced by a recorded op: a live tensor (a parameter,
            # a buffer) read again at each Executor.run
            self._slot_const[slot] = t
        return slot

    def _tracked(self, t) -> bool:
        return id(t) in self._slot_of

    def _record(self, name, fn, inputs, outputs) -> None:
        if not any(self._tracked(i) for i in inputs):
            return
        in_slots = [self._slot_for(i) for i in inputs]
        out_slots = []
        for o in outputs:
            slot = self._next_slot
            self._next_slot += 1
            self._slot_of[id(o)] = slot
            out_slots.append(slot)
        self._keepalive.extend(inputs)
        self._keepalive.extend(outputs)
        self.ops.append((fn, in_slots, out_slots))
        self._version += 1

    def _register_feed(self, name: str, placeholder) -> None:
        slot = self._next_slot
        self._next_slot += 1
        self._slot_of[id(placeholder)] = slot
        self._feed_slots[name] = slot
        self._slot_const[slot] = placeholder
        # a new feed changes the replay signature
        self._version += 1

    def global_block(self):
        return self

    def clone(self, for_test=False):
        import copy
        return copy.copy(self)

    def __repr__(self):
        return f"<Program with {len(self.ops)} recorded ops>"


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    """Route op capture into ``main_program``: ops touching ``data()``
    placeholders are recorded for Executor replay; everything still
    executes eagerly too."""
    global _main_program, _startup_program
    from ..ops import dispatch as _dispatch
    prev = (_main_program, _startup_program)
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program

    def hook(name, fn, inputs, outputs):
        main_program._record(name, fn, inputs, outputs)

    prev_hook = _dispatch._capture_hook
    _dispatch.set_capture_hook(hook)
    try:
        yield
    finally:
        _dispatch.set_capture_hook(prev_hook)
        _main_program, _startup_program = prev


@contextlib.contextmanager
def name_scope(prefix=None):
    yield


class _Scope(dict):
    def var(self, name):
        return self.setdefault(name, None)

    def find_var(self, name):
        return self.get(name)


_scope = _Scope()


def global_scope():
    return _scope


@contextlib.contextmanager
def scope_guard(scope):
    yield


def cpu_places(device_count=None):
    return [CPUPlace()]


@contextlib.contextmanager
def device_guard(device=None):
    yield


def data(name: str, shape, dtype="float32", lod_level=0):
    """Declare a feed placeholder in the current program: zeros of the
    (None -> 1) example shape on the current place, registered as a feed
    slot so ``Executor.run(feed={name: ...})`` substitutes real values."""
    prog = default_main_program()
    spec = InputSpec([s if s is not None else -1 for s in shape], dtype,
                     name)
    prog._feed_targets[name] = spec
    t = to_tensor(np.zeros([1 if (s is None or s < 0) else s
                            for s in shape], dtype=str(dtype)))
    t.name = name
    prog._register_feed(name, t)
    return t


def _feed_array(value, spec, device) -> torch.Tensor:
    arr = _to_torch(value if isinstance(value, (Tensor, torch.Tensor))
                    else np.asarray(value), None, None, device=device)
    want = str(getattr(spec, "dtype", "") or "")
    if want:
        from ..framework import dtype as dtypes
        arr = arr.to(dtypes.to_torch_dtype(want))
    return arr.to(device)


class Executor:
    """Mirror of ``paddle.static.Executor``: runs a captured Program with a
    feed dict and a fetch list (see the module docstring)."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place or CPUPlace()
        self._compiled: Dict[tuple, Any] = {}

    def _replay(self, program: Program, feed: Dict[str, Any],
                fetch_list) -> List[torch.Tensor]:
        fetch_slots = []
        for target in fetch_list:
            slot = program._slot_of.get(id(target))
            if slot is None:
                raise KeyError(
                    f"fetch target {getattr(target, 'name', target)!r} "
                    f"was not captured by this program; build it under "
                    f"program_guard from static.data inputs")
            fetch_slots.append(slot)
        feed_names = sorted(program._feed_slots)
        missing = [n for n in feed_names if n not in feed]
        if missing:
            raise KeyError(f"missing feed entries: {missing}")
        unknown = [n for n in feed if n not in program._feed_slots]
        if unknown:
            raise KeyError(
                f"unknown feed entries {unknown}; this program's feeds are "
                f"{feed_names} (a typo here would silently run on stale "
                f"values)")
        feed_slot_ids = [program._feed_slots[n] for n in feed_names]
        const_slots = sorted(s for s in program._slot_const
                             if s not in feed_slot_ids)
        device = program._slot_const[feed_slot_ids[0]]._data.device \
            if feed_slot_ids else torch.device("cpu")
        feed_vals = [_feed_array(feed[n], program._feed_targets[n], device)
                     for n in feed_names]
        const_vals = [program._slot_const[s]._data.detach()
                      for s in const_slots]
        ops = list(program.ops)

        def replay(*feeds):
            env = dict(zip(feed_slot_ids, feeds))
            env.update(zip(const_slots, const_vals))
            for fn, in_slots, out_slots in ops:
                outs = fn(*[env[s] for s in in_slots])
                if not isinstance(outs, (tuple, list)):
                    outs = (outs,)
                env.update(zip(out_slots, outs))
            return [env[s] for s in fetch_slots]

        with torch.no_grad():
            if device.type != "cuda":
                return replay(*feed_vals)
            key = (id(program), program._version, tuple(fetch_slots),
                   tuple((tuple(f.shape), f.dtype) for f in feed_vals),
                   tuple(c.data_ptr() for c in const_vals))
            call = self._compiled.get(key)
            if call is None:
                from ..jit.capture import CapturedCall
                call = self._compiled[key] = CapturedCall(replay, feed_vals)
            return call.run(feed_vals)

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True, **kwargs):
        feed = feed or {}
        fetch_list = fetch_list or []
        if program is not None and hasattr(program, "get_input_names") \
                and hasattr(program, "run"):
            # an inference Predictor from load_inference_model
            names = program.get_input_names()
            ordered = [np.asarray(feed[n]) for n in names] if feed else []
            outs = program.run(ordered)
            return outs if return_numpy else [to_tensor(o) for o in outs]
        prog = program if isinstance(program, Program) else \
            default_main_program()
        tensor_fetches = [t for t in fetch_list
                          if isinstance(t, Tensor) and
                          prog._slot_of.get(id(t)) is not None]
        replayed: Dict[int, Any] = {}
        if tensor_fetches and prog.ops:
            outs = self._replay(prog, feed, tensor_fetches)
            replayed = {id(t): o for t, o in zip(tensor_fetches, outs)}
        results = []
        for target in fetch_list:
            if id(target) in replayed:
                out = wrap_array(replayed[id(target)])
                results.append(out.numpy() if return_numpy else out)
                continue
            if callable(target) and not isinstance(target, Tensor):
                out = target(**{k: to_tensor(v) for k, v in feed.items()})
            elif isinstance(target, Tensor):
                out = target     # eager value (not captured)
            else:
                raise TypeError(
                    f"cannot fetch {target!r}: fetch Tensors built "
                    "under program_guard, or callables")
            if return_numpy and isinstance(out, Tensor):
                out = out.numpy()
            results.append(out)
        return results

    def close(self):
        pass


def _model_of(fetch_vars, program=None):
    if program is not None:
        return program
    fv = fetch_vars if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    return next((f for f in fv if callable(f) and not isinstance(f, Tensor)),
                None)


def _feed_specs(feed_vars):
    feeds = feed_vars if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    return [(tuple(t.shape), str(t.dtype).replace("paddle.", ""))
            for t in feeds]


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor,
                         program=None, **kwargs):
    """Export a model for serving (``inference.convert_to_export`` at the
    feed variables' shapes and types).  ``fetch_vars`` (or ``program``)
    must hold the model callable or Layer, as in JAX: the static program
    is a traced function, not a recorded graph."""
    from ..inference import convert_to_export
    target = _model_of(fetch_vars, program)
    if target is None:
        raise TypeError(
            "save_inference_model needs the model callable or Layer as "
            "program= or among fetch_vars: the static path exports a "
            "traced function, not a recorded graph")
    return convert_to_export(target, _feed_specs(feed_vars), path_prefix)


def load_inference_model(path_prefix, executor, **kwargs):
    """Load an exported model -> (predictor, feed_names, fetch_names); pass
    the predictor as ``program=`` to ``Executor.run`` or call it."""
    from ..inference import ARTIFACT_SUFFIX, Config, create_predictor
    path = path_prefix if path_prefix.endswith(ARTIFACT_SUFFIX) else \
        path_prefix + ARTIFACT_SUFFIX
    pred = create_predictor(Config(path))
    return pred, list(pred.get_input_names()), list(pred.get_output_names())


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    from ..autograd import grad as agrad
    return agrad(targets, inputs, grad_outputs=target_gradients,
                 allow_unused=True)


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    loss.backward()
    params = parameter_list or []
    return [(p, p.grad) for p in params]


class nn:
    """paddle.static.nn shims (fc maps onto the dynamic Linear)."""

    @staticmethod
    def fc(x, size, num_flatten_dims=1, activation=None, name=None):
        from ..nn import Linear
        from ..nn import functional as F
        out = Linear(x.shape[-1], size)(x)
        if activation:
            out = getattr(F, activation)(out)
        return out


# ---------------------------------------------------------------------------
# program state and serialization
# ---------------------------------------------------------------------------
def save(program, model_path, protocol=4, **configs):
    """Persist a Layer's state_dict (or a state dict) to ``model_path``
    (``.pdparams``)."""
    from ..framework.io import save as fsave
    state = program.state_dict() if hasattr(program, "state_dict") \
        else program
    fsave(state, model_path if model_path.endswith(".pdparams")
          else model_path + ".pdparams")


def load(program, model_path, executor=None, var_list=None):
    from ..framework.io import load as fload
    path = model_path if model_path.endswith(".pdparams") \
        else model_path + ".pdparams"
    state = fload(path)
    if hasattr(program, "set_state_dict"):
        program.set_state_dict(state)
        return program
    return state


def load_program_state(model_path, var_list=None):
    """The state_dict as numpy arrays."""
    state = load(None, model_path)
    return {k: (v.numpy() if hasattr(v, "numpy") else v)
            for k, v in state.items()}


def set_program_state(program, state_dict):
    if not hasattr(program, "set_state_dict"):
        raise TypeError("pass the Layer to restore as `program`")
    program.set_state_dict(state_dict)


def serialize_program(feed_vars, fetch_vars, **kwargs):
    """The exported program's bytes (``inference.convert_to_export``)."""
    from ..inference import convert_to_export
    target = _model_of(fetch_vars)
    if target is None:
        raise TypeError("fetch_vars must include the model callable")
    with tempfile.TemporaryDirectory() as d:
        path = convert_to_export(target, _feed_specs(feed_vars),
                                 os.path.join(d, "m"))
        with open(path, "rb") as f:
            return f.read()


def serialize_persistables(feed_vars, fetch_vars, **kwargs):
    target = next((f for f in (fetch_vars if isinstance(
        fetch_vars, (list, tuple)) else [fetch_vars])
        if hasattr(f, "state_dict")), None)
    if target is None:
        raise TypeError("fetch_vars must include the Layer")
    state = {k: v.numpy() for k, v in target.state_dict().items()}
    return pickle.dumps(state)


def save_to_file(path, content: bytes):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def deserialize_program(data: bytes):
    """A callable running the serialized program: ``run(*inputs) ->
    [torch tensors]`` (``run.exported`` is the ``ExportedProgram``)."""
    from ..inference import _as_input
    ep = torch.export.load(io.BytesIO(data))
    module = ep.module()

    def run(*inputs):
        out = module(*[_as_input(x) for x in inputs])
        return list(out) if isinstance(out, (list, tuple)) else [out]

    run.exported = ep
    return run


def deserialize_persistables(program, data: bytes, executor=None):
    state = pickle.loads(data)
    if hasattr(program, "set_state_dict"):
        program.set_state_dict(state)
        return program
    return state


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    """The exported program needs no feed / fetch pruning: returns the
    program unchanged."""
    return program


# ---------------------------------------------------------------------------
# vars and metric ops
# ---------------------------------------------------------------------------
def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    t = to_tensor(np.full(shape, value, dtype=str(dtype)))
    t.persistable = persistable
    if name:
        t.name = name
    return t


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..framework.param import Parameter, ParamAttr
    from ..framework.place import current_torch_device
    from ..nn import initializer as I
    attr = ParamAttr._to_attr(attr)
    init = (attr.initializer if attr is not None and attr.initializer
            else default_initializer) or (
        I.Constant(0.0) if is_bias else I.XavierNormal())
    data = init(shape, dtype, current_torch_device())
    return Parameter(data, dtype=dtype,
                     name=name or (attr.name if attr else None),
                     trainable=attr.trainable if attr else True,
                     attr=attr)


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-k accuracy op."""
    from ..metric import accuracy as _acc
    return _acc(input, label, k=k)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1, name=None):
    """Batch AUC -> (auc_value, batch_auc, [state])."""
    from ..metric import Auc
    m = Auc(curve=curve, num_thresholds=num_thresholds)
    m.update(np.asarray(input.numpy()), np.asarray(label.numpy()))
    v = to_tensor(np.asarray(m.accumulate(), np.float32))
    return v, v, []


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """Debug-print op: prints eagerly and returns the input unchanged."""
    prefix = (message + " ") if message else ""
    print(f"{prefix}{getattr(input, 'name', 'var')} "
          f"shape={tuple(input.shape)} values="
          f"{input.numpy().reshape(-1)[:summarize]}")
    return input


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """A host Python function as an op: ``func`` takes and returns numpy
    arrays shaped and typed as ``out``."""
    from ..ops.dispatch import apply, as_tensor
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]

    def fn(*arrays):
        res = func(*[wrap_array(a.detach()).numpy() for a in arrays])
        res = res if isinstance(res, (list, tuple)) else [res]
        got = tuple(torch.as_tensor(np.asarray(r)).to(
            device=arrays[0].device, dtype=o._data.dtype)
            for r, o in zip(res, outs))
        return got if len(got) > 1 else got[0]

    return apply("py_func", fn, *[as_tensor(t) for t in xs])


from ..framework.param import ParamAttr as _ParamAttr  # noqa: E402


class WeightNormParamAttr(_ParamAttr):
    """Weight-normalized parameter attr, carried as metadata."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        super().__init__(name=name, initializer=initializer,
                         learning_rate=learning_rate, trainable=trainable)
        self.dim = dim


class ExponentialMovingAverage:
    """EMA of parameters: ``update()`` after each step; ``apply()`` /
    ``restore()`` put the averaged weights in the parameters' own storage
    for evaluation and back."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._ema = {}
        self._backup = {}
        self._params = []
        self._step = 0

    def _track(self, params):
        self._params = list(params)
        for p in self._params:
            if id(p) not in self._ema:
                # zero-initialized so the 1 - decay**t debias is exact
                self._ema[id(p)] = torch.zeros_like(p._data.detach())

    @torch.no_grad()
    def update(self, parameters=None):
        if parameters is not None or not self._params:
            if parameters is None:
                raise ValueError("pass parameters= on first update()")
            self._track(parameters)
        self._step += 1
        d = self._decay
        for p in self._params:
            self._ema[id(p)] = d * self._ema[id(p)] + (1.0 - d) * \
                p._data.detach()

    def apply(self, executor=None, need_restore=True):
        @contextlib.contextmanager
        def guard():
            bias_fix = 1.0 - self._decay ** max(self._step, 1)
            with torch.no_grad():
                self._backup = {id(p): p._data.detach().clone()
                                for p in self._params}
                for p in self._params:
                    p._data.copy_(self._ema[id(p)] / bias_fix)
            try:
                yield
            finally:
                if need_restore:
                    self.restore()
        return guard()

    @torch.no_grad()
    def restore(self, executor=None):
        for p in self._params:
            if id(p) in self._backup:
                p._data.copy_(self._backup[id(p)])
        self._backup = {}


class BuildStrategy:
    """Graph-build knobs, recorded for compatibility (the port's programs
    are CUDA graphs of the eager kernels)."""

    def __init__(self):
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.enable_auto_fusion = True
        self.memory_optimize = True
        self.reduce_strategy = 0
        self.build_cinn_pass = False


class CompiledProgram:
    """Wraps a program for execution; the Executor captures it."""

    def __init__(self, program, build_strategy=None):
        self._program = program
        self.build_strategy = build_strategy or BuildStrategy()

    def __getattr__(self, item):
        return getattr(self._program, item)


def cuda_places(device_ids=None):
    """A CUDAPlace for each visible card (or each of ``device_ids``)."""
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in device_ids]


def xpu_places(device_ids=None):
    return []


def ipu_shard_guard(index=-1, stage=-1):
    @contextlib.contextmanager
    def guard():
        yield
    return guard()


def set_ipu_shard(layer, index=-1, stage=-1):
    return layer


class IpuStrategy:
    def __init__(self):
        raise RuntimeError("IPU devices are not supported by this build")


class IpuCompiledProgram:
    def __init__(self, *a, **k):
        raise RuntimeError("IPU devices are not supported by this build")


def ctr_metric_bundle(input, label, ins_tag_weight=None):
    """CTR metrics -> (sqrerr, abserr, prob, q, pos, total)."""
    p = np.asarray(input.numpy()).reshape(-1)
    y = np.asarray(label.numpy()).reshape(-1).astype(np.float64)
    sqrerr = float(((p - y) ** 2).sum())
    abserr = float(np.abs(p - y).sum())
    prob = float(p.sum())
    q = float(p.sum())
    pos = float(y.sum())
    total = float(len(y))
    return tuple(to_tensor(np.asarray(v, np.float32))
                 for v in (sqrerr, abserr, prob, q, pos, total))


__all__ += ["save", "load", "load_program_state", "set_program_state",
            "serialize_program", "serialize_persistables", "save_to_file",
            "load_from_file", "deserialize_program",
            "deserialize_persistables", "normalize_program",
            "create_global_var", "create_parameter", "accuracy", "auc",
            "Print", "py_func", "WeightNormParamAttr",
            "ExponentialMovingAverage", "BuildStrategy", "CompiledProgram",
            "cuda_places", "xpu_places", "ipu_shard_guard", "set_ipu_shard",
            "IpuStrategy", "IpuCompiledProgram", "ctr_metric_bundle"]
