"""``einsum`` (counterpart of ``paddle_tpu/tensor/einsum.py``): torch's
contraction, on the AMP white list under JAX's name."""

from __future__ import annotations

import torch

from ..ops.dispatch import apply, as_tensor

__all__ = ["einsum"]


def einsum(equation, *operands):
    ts = [as_tensor(o) for o in operands]
    eq = str(equation)
    return apply("einsum", lambda *arrs: torch.einsum(eq, *arrs), *ts)
