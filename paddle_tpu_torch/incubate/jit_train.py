"""One training step of a Layer model as one program: ``jit_train_step``.

Counterpart of ``paddle_tpu/incubate/jit_train.py``.  JAX compiles the
forward under ``auto_cast``, the backward, the clip and the optimizer's own
``_update`` rule into one XLA program.  The port runs the same pieces in
the same order, and on a CUDA device captures them into one
``torch.cuda.CUDAGraph`` for each input signature (the inputs' shapes and
types, the model's train / eval mode, the parameters' and buffers'
addresses and the port's flags): the first call of a signature runs the
step once on a side stream without writing anything back (it builds the
kernels and warms the libraries), captures it, and replays; every later
call copies the batch into the graph's static inputs and the learning rate
into a device scalar, then replays.  A capture or a replay that fails
raises: there is no eager fallback on the card.  On the CPU the same step
runs eagerly, because the caller chose that device.  A ``jit.to_static``
proxy is stepped through the Layer it wraps (its graphs are not captured
inside the step's).

The semantics are JAX's:

* only the optimizer's own parameters are updated; the rest of the
  model's are read;
* a parameter the loss never reaches gets a zero gradient (and AdamW still
  decays it);
* ``ClipGradByGlobalNorm`` is the one clip taken, scaling by ``min(1, c /
  (n + 1e-12))`` (the eager clip's ``c / max(n, c)`` is JAX's eager
  formula); the others raise ``NotImplementedError``;
* ``amp_level`` is O0 or O1; O2, and float16 O1 (which would need loss
  scaling), raise;
* the optimizer's state (moments, ``beta*_pow`` as device scalars, the
  master copies of ``multi_precision``) is the optimizer's own, so its
  ``state_dict()`` carries it with ``"@step"``;
* a buffer the forward rebinds is written back into the buffer's own
  storage, so the next step reads it; a buffer rebound between steps
  (``set_state_dict``, an eager forward in train mode) is copied back into
  that storage before the next step;
* dropout draws from the framework's generator of the device, which the
  graph registers: every replay draws a fresh mask, and two runs after the
  same ``paddle.seed`` draw the same ones.

:func:`jit_eval_step` runs ``model(*x)`` under ``no_grad`` with a
generator of its own (so evaluating does not move the training stream),
eagerly on either device, and raises when the model's train / eval mode
has flipped since it was built.  A step's ``graphs()`` lists its
:class:`TrainGraph` s (``replays``, ``capture_launches``: the kernel
launches recorded at capture, which every replay runs again).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import flags as _flags
from ..amp import auto_cast
from ..framework import random as framework_random
from ..jit import inner_layer
from ..nn.clip import ClipGradByGlobalNorm
from ..nn.layer.layers import Layer
from ..tensor.tensor import Tensor, wrap_array

__all__ = ["jit_train_step", "jit_eval_step", "TrainGraph"]

_EVAL_SEQ = [0]


def _flat(v) -> List[torch.Tensor]:
    items = v if isinstance(v, (tuple, list)) else (v,)
    out = []
    for a in items:
        if isinstance(a, Tensor):
            a = a._data
        elif not isinstance(a, torch.Tensor):
            a = np.asarray(a)
            a = torch.from_numpy(a.astype(np.float32) if a.dtype ==
                                 np.float64 else a)
        out.append(a.detach())
    return out


def _rewrap(arrs, as_tuple: bool):
    ts = tuple(wrap_array(a) for a in arrs)
    return ts if as_tuple else ts[0]


def _tree_data(out):
    """The tensors of a tree of Tensors, detached."""
    if isinstance(out, Tensor):
        return out._data.detach()
    if isinstance(out, (tuple, list)):
        return type(out)(_tree_data(o) for o in out)
    return out


def _tree_wrap(out, copy: bool):
    if isinstance(out, torch.Tensor):
        return wrap_array(out.clone() if copy else out)
    if isinstance(out, (tuple, list)):
        return type(out)(_tree_wrap(o, copy) for o in out)
    return out


class TrainGraph:
    """The captured step of one signature: static inputs, the static loss
    and outputs, the graph, ``replays`` and ``capture_launches``."""

    def __init__(self, xs, ys):
        self.xs = [torch.empty_like(a) for a in xs]
        self.ys = [torch.empty_like(a) for a in ys]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.loss = None
        self.outs = None
        self.replays = 0
        self.capture_launches: Dict[str, int] = {}

    def load(self, xs, ys) -> None:
        for dst, src in zip(self.xs + self.ys, xs + ys):
            dst.copy_(src, non_blocking=True)


def jit_train_step(model: Layer, loss_fn: Callable, optimizer,
                   amp_level: str = "O0", amp_dtype: str = "bfloat16",
                   return_outputs: bool = False):
    """``loss_fn(model(*x), y)``, its backward, the clip and ``optimizer``
    as one step.  Returns ``step(x, y) -> loss`` (``(loss, outputs)``
    with ``return_outputs=True``); ``x`` / ``y`` are a Tensor or a tuple
    of them (``model(*x)``, ``loss_fn(out, y_tuple)``).  Parameters and
    the optimizer's state stay on the device between calls."""
    model = inner_layer(model)      # a to_static proxy: its Layer
    clip = getattr(optimizer, "_grad_clip", None)
    if clip is not None and not isinstance(clip, ClipGradByGlobalNorm):
        raise NotImplementedError(
            "jit_train_step supports grad_clip=None or "
            "ClipGradByGlobalNorm; other clips need the eager path")
    if amp_level not in ("O0", "O1"):
        raise NotImplementedError(
            "jit_train_step amp_level must be O0 or O1 (O2 master-weight "
            "decoration belongs to amp.decorate and the eager loop)")
    if amp_level == "O1" and amp_dtype == "float16":
        raise NotImplementedError(
            "float16 autocast needs GradScaler loss scaling, which the "
            "compiled step does not take: use bfloat16, or the eager loop "
            "with amp.GradScaler")

    all_params = [p for _, p in model.named_parameters()]
    opt_ids = {id(p) for p in optimizer._params()}
    trained = [p for p in all_params
               if not p.stop_gradient and id(p) in opt_ids]
    if not trained:
        raise ValueError("the optimizer holds none of the model's trainable "
                         "parameters")
    # (owning layer, name, the buffer Tensor, its storage)
    buffers = [(layer, name, b, b._data)
               for _, layer in model.named_sublayers(include_self=True)
               for name, b in layer._buffers.items() if b is not None]
    device = trained[0]._data.device
    clipped = [i for i, p in enumerate(trained)
               if getattr(p, "need_clip", True)]

    # the optimizer's own state, its numbers made device scalars: a
    # Python float would keep its capture-time value in every replay
    states = []
    for p in trained:
        st = optimizer._get_state(p)
        for k, v in list(st.items()):
            if isinstance(v, (int, float)):
                st[k] = torch.tensor(float(v), dtype=torch.float64,
                                     device=device)
        states.append(st)
    lr_t = torch.zeros((), dtype=torch.float64, device=device)

    def body(xs, ys, x_tuple, y_tuple, write):
        """Forward, backward, clip and update; ``write`` puts the results
        into the parameters, the state and the buffers."""
        with auto_cast(enable=amp_level == "O1", level="O1",
                       dtype=amp_dtype):
            out = model(*_rewrap(xs, True))
            loss = loss_fn(out, _rewrap(ys, y_tuple))
        loss_d = loss._data if isinstance(loss, Tensor) else loss
        grads = torch.autograd.grad(loss_d, [p._data for p in trained],
                                    allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(p._data) if g is None else g
                     for p, g in zip(trained, grads)]
            if clip is not None and clipped:
                sq = [torch.sum(torch.square(grads[i].float()))
                      for i in clipped]
                norm = torch.sqrt(torch.stack(sq).sum())
                scale = torch.clamp(clip.clip_norm / (norm + 1e-12),
                                    max=1.0)
                for i in clipped:
                    grads[i] = grads[i] * scale.to(grads[i].dtype)
            for p, g, st in zip(trained, grads, states):
                optimizer._current_param = p
                master = st.get("master")
                compute = p._data if master is None else master
                new_p, new_s = optimizer._update(
                    compute, g if master is None else g.float(), st, lr_t)
                if write:
                    for k, v in new_s.items():
                        st[k].copy_(v)
                    if master is not None:
                        master.copy_(new_p)
                    p._data.copy_(new_p)
            optimizer._current_param = None
            for layer, name, b, data in buffers:
                new = layer._buffers[name]
                if new is not b or b._data is not data:
                    if write:
                        data.copy_(new._data)
                    b._data = data
                    layer._buffers[name] = b
        return loss_d.detach(), _tree_data(out)

    cache: Dict[tuple, TrainGraph] = {}

    def signature(xs, ys, x_tuple, y_tuple):
        return (model.training, x_tuple, y_tuple,
                tuple((tuple(a.shape), a.dtype) for a in xs + ys),
                tuple(p._data.data_ptr() for p in all_params),
                tuple(b[3].data_ptr() for b in buffers),
                tuple(sorted(_flags.get_flags().items())))

    def capture(g, x_tuple, y_tuple):
        from ..jit.capture import capture as _capture

        def run(write):
            g.loss, g.outs = body(g.xs, g.ys, x_tuple, y_tuple, write)

        try:
            g.graph, g.capture_launches = _capture(
                device, lambda: run(False), lambda: run(True),
                framework_random.generator(device))
        except BaseException:
            framework_random.renew_generator(device)
            raise

    def rehome_buffers():
        """A buffer rebound outside the step (``set_state_dict``, a
        forward run eagerly) goes back into its own storage, which the
        captured graphs read."""
        with torch.no_grad():
            for layer, name, b, data in buffers:
                cur = layer._buffers[name]
                if cur is not b or b._data is not data:
                    data.copy_(cur._data)
                    b._data = data
                    layer._buffers[name] = b

    def step(x, y):
        rehome_buffers()
        x_tuple, y_tuple = isinstance(x, (tuple, list)), \
            isinstance(y, (tuple, list))
        xs = [a.to(device) for a in _flat(x)]
        ys = [a.to(device) for a in _flat(y)]
        lr_t.fill_(float(optimizer.get_lr()))
        if device.type != "cuda":
            loss, outs = body(xs, ys, x_tuple, y_tuple, True)
            copy = False
        else:
            key = signature(xs, ys, x_tuple, y_tuple)
            g = cache.get(key)
            if g is None:
                g = TrainGraph(xs, ys)
                g.load(xs, ys)
                capture(g, x_tuple, y_tuple)
                cache[key] = g
            else:
                g.load(xs, ys)
            g.graph.replay()
            g.replays += 1
            loss, outs, copy = g.loss, g.outs, True
        optimizer._step_count += 1
        loss_t = _tree_wrap(loss, copy)
        if return_outputs:
            return loss_t, _tree_wrap(outs, copy)
        return loss_t

    step.graphs = lambda: list(cache.values())     # -> List[TrainGraph]
    return step


def jit_eval_step(model: Layer):
    """``fwd(x) -> model(*x)`` under ``no_grad``, parameters and buffers
    read live at each call.  Dropout in a train-mode model draws from a
    generator of this step's own, seeded from the framework's seed and a
    per-build counter, so evaluating leaves the training stream where it
    was.  Raises when the model's train / eval mode differs from its mode
    at build."""
    model = inner_layer(model)
    mode = model.training
    _EVAL_SEQ[0] += 1
    seed = (framework_random.initial_seed()
            ^ (0xA5EDC0DE + _EVAL_SEQ[0])) & 0xFFFFFFFF
    gens: Dict[torch.device, torch.Generator] = {}

    def fwd(x):
        if model.training != mode:
            raise RuntimeError(
                "jit_eval_step was built with this model in "
                f"{'train' if mode else 'eval'} mode but it is now in the "
                "other mode: rebuild the step after train() / eval()")
        params = model.parameters()
        dev = params[0]._data.device if params else torch.device("cpu")
        gen = gens.get(dev)
        if gen is None:
            gen = gens[dev] = torch.Generator(device=dev).manual_seed(seed)
        xs = [a.to(dev) for a in _flat(x)]
        with torch.no_grad(), framework_random.generator_guard(gen):
            out = model(*_rewrap(xs, True))
        return _tree_wrap(_tree_data(out), False)

    return fwd
