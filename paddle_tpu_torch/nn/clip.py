"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

A clip is called by the optimizer's eager ``step`` on its
``[(param, grad)]`` list and returns the list with the clipped gradients;
a parameter with ``need_clip=False`` keeps its gradient and stays out of
the global norm.  Every scale is computed on the device (no host read).
``incubate.jit_train_step`` takes ``ClipGradByGlobalNorm`` only and scales
by its compiled step's own formula, ``min(1, c / (n + 1e-12))``, where the
eager clip below scales by JAX's eager ``c / max(n, c)``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..ops.dispatch import apply, as_tensor
from ..tensor.tensor import Tensor

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


def _clipped(p, g) -> bool:
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads: List[Tuple[Tensor, Tensor]]):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each element into ``[min, max]`` (``min`` defaults to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, apply("clip_value",
                          lambda a: torch.clamp(a, self.min, self.max), g)
                 if _clipped(p, g) else g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        def fn(a):
            nrm = torch.linalg.vector_norm(a.reshape(-1))
            return a * torch.clamp(self.clip_norm / torch.clamp(
                nrm, min=1e-12), max=1.0)

        return [(p, apply("clip_norm", fn, g) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    """Every clipped gradient times ``c / max(n, c)``, n the L2 norm of
    all of them together (summed in f32)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [g for p, g in params_grads if _clipped(p, g)]
        if not grads:
            return params_grads
        sq = [apply("sumsq", lambda a: torch.sum(torch.square(a.float())),
                    g) for g in grads]
        total = sq[0]
        for s in sq[1:]:
            total = total + s
        global_norm = apply("sqrt", torch.sqrt, total)
        clip_t = as_tensor(self.clip_norm, device=global_norm._data.device)
        scale = apply("clip_scale", lambda n, c: c / torch.maximum(n, c),
                      global_norm, clip_t)
        return [(p, apply("apply_scale",
                          lambda a, s: (a.float() * s).to(a.dtype), g, scale)
                 if _clipped(p, g) else g) for p, g in params_grads]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the parameters' ``.grad`` in place by ``max_norm / (n +
    1e-6)`` where that is below 1; -> the total norm n as a Tensor."""
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    grads = [p._data.grad for p in parameters if p._data.grad is not None]
    if not grads:
        return as_tensor(0.0)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = sum(torch.sum(g.abs() ** norm_type) for g in grads) \
            ** (1.0 / norm_type)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef.to(g.dtype))
    return as_tensor(total)


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp the parameters' ``.grad`` into ``[-clip_value, clip_value]``
    in place."""
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    for p in parameters:
        if p._data.grad is not None:
            p._data.grad.clamp_(-clip_value, clip_value)
