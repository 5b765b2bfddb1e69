"""paddle.autograd on torch's engine.

Counterpart of ``paddle_tpu/autograd/__init__.py``: ``no_grad`` /
``enable_grad`` / ``set_grad_enabled`` / ``is_grad_enabled`` (torch's own
guards), :func:`backward` and :func:`grad` (``paddle.grad`` with
``retain_graph`` and ``allow_unused``; leaves' ``.grad`` untouched).  Not
ported yet (ROADMAP.md queue 1 item 10): ``create_graph=True`` (double
grad), PyLayer, ``jacobian`` / ``hessian`` / ``vjp`` / ``jvp``.
"""

from __future__ import annotations

import torch

from . import tape
from .tape import run_backward

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "grad", "backward"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def backward(tensors, grad_tensors=None, retain_graph=False) -> None:
    """Mirror of ``paddle.autograd.backward``."""
    if not isinstance(tensors, (list, tuple)):
        tensors = [tensors]
    if grad_tensors is not None and not isinstance(grad_tensors,
                                                   (list, tuple)):
        grad_tensors = [grad_tensors]
    run_backward(list(tensors), grad_tensors, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None, name=None):
    """Mirror of ``paddle.grad``: the gradients of ``outputs`` with respect
    to ``inputs`` as new tensors, without touching any ``.grad``.  An input
    the outputs do not reach raises unless ``allow_unused``, which gives
    ``None`` for it."""
    from ..tensor.tensor import wrap_array
    if create_graph:
        raise NotImplementedError(
            "paddle.grad(create_graph=True) (double grad) is not ported yet "
            "(ROADMAP.md queue 1 item 10)")
    single = not isinstance(inputs, (list, tuple))
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) else \
        [outputs]
    inputs = [inputs] if single else list(inputs)
    if grad_outputs is not None and not isinstance(grad_outputs,
                                                   (list, tuple)):
        grad_outputs = [grad_outputs]
    skip = {id(v) for v in (no_grad_vars or [])}
    outs, seeds = [], []
    for i, o in enumerate(outputs):
        g = grad_outputs[i] if grad_outputs is not None else None
        if g is None:
            if o._data.numel() != 1:
                raise RuntimeError(
                    "grad can be implicitly created only for scalar outputs; "
                    f"got shape {tuple(o.shape)}")
            g = torch.ones_like(o._data)
        else:
            g = g._data if hasattr(g, "_data") else torch.as_tensor(g)
        if o._data.requires_grad:
            outs.append(o._data)
            seeds.append(g)
    wanted = [t for t in inputs
              if t._data.requires_grad and id(t) not in skip]
    got = {}
    if outs and wanted:
        nodes = tape.graph_nodes([d.grad_fn for d in outs])
        tape.check_not_released(nodes)
        res = torch.autograd.grad(outs, [t._data for t in wanted], seeds,
                                  retain_graph=bool(retain_graph),
                                  allow_unused=True)
        if not retain_graph:
            tape.mark_released(nodes)
        got = {id(t): g for t, g in zip(wanted, res)}
    results = []
    for t in inputs:
        g = got.get(id(t))
        if g is None and id(t) not in skip and not allow_unused:
            raise RuntimeError(
                f"input tensor {t.name} is unreachable from outputs "
                "(set allow_unused=True to return None)")
        results.append(None if g is None else wrap_array(g))
    return results
