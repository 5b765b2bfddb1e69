"""``matmul`` (counterpart of ``paddle_tpu/tensor/linalg.py:matmul``)."""

from __future__ import annotations

import torch

from ..ops.dispatch import apply, as_tensor

__all__ = ["matmul"]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y``, each operand's last two axes swapped first when asked."""
    tx, ty = bool(transpose_x), bool(transpose_y)

    def fn(a, b):
        if tx and a.dim() > 1:
            a = a.transpose(-1, -2)
        if ty and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return apply("matmul", fn, as_tensor(x), as_tensor(y))
