"""Reverse-mode autograd on torch's engine.

Counterpart of ``paddle_tpu/autograd/tape.py``.  JAX's package records a
``jax.vjp`` pullback per op on a tape of its own; here torch records every
op as it runs, so the tape is torch's graph and this module keeps only
what Paddle's semantics add on top of it:

* :func:`run_backward` seeds the outputs (a non-scalar output without a
  gradient raises, as in JAX), runs torch's backward into the leaves'
  ``.grad`` and, unless ``retain_graph``, marks every node it ran as
  released.  A later backward through a released node raises, also where
  torch would run the node again because it saved no tensor (JAX's graph
  raises for every op).
The grad-mode guards are torch's own (``autograd/__init__.py``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

__all__ = ["run_backward", "graph_nodes", "check_not_released",
           "mark_released"]

_RELEASED = "paddle_released"


def graph_nodes(roots: Sequence[Any]) -> List[Any]:
    """Every node reachable from the ``grad_fn`` nodes ``roots``, leaves'
    accumulators left out (they outlive a graph)."""
    seen, out = set(), []
    stack = [r for r in roots if r is not None]
    while stack:
        node = stack.pop()
        if node in seen or hasattr(node, "variable"):
            continue
        seen.add(node)
        out.append(node)
        stack.extend(n for n, _ in node.next_functions if n is not None)
    return out


def check_not_released(nodes) -> None:
    for node in nodes:
        if node.metadata.get(_RELEASED):
            raise RuntimeError(
                f"trying to backward through {node.name()} a second time; "
                "call backward(retain_graph=True) the first time")


def mark_released(nodes) -> None:
    for node in nodes:
        node.metadata[_RELEASED] = True


def run_backward(tensors: Sequence[Any],
                 grad_tensors: Optional[Sequence[Any]] = None,
                 retain_graph: bool = False) -> None:
    """Gradients of ``tensors`` into every reachable leaf's ``.grad``."""
    tensors = [t for t in tensors if t is not None]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    if len(grad_tensors) != len(tensors):
        raise ValueError("grad_tensors length mismatch")
    outs, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        d = t._data
        if g is None:
            if d.numel() != 1:
                raise RuntimeError(
                    "grad can be implicitly created only for scalar outputs; "
                    f"got shape {tuple(d.shape)}")
            g = torch.ones_like(d)
        else:
            g = g._data if hasattr(g, "_data") else torch.as_tensor(
                g, dtype=d.dtype, device=d.device)
        if d.requires_grad:
            outs.append(d)
            seeds.append(g)
    if not outs:
        return
    nodes = graph_nodes([d.grad_fn for d in outs])
    check_not_released(nodes)
    torch.autograd.backward(outs, seeds, retain_graph=retain_graph)
    if not retain_graph:
        mark_released(nodes)
