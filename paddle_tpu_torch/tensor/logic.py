"""Elementwise comparisons (counterpart of ``paddle_tpu/tensor/logic.py``'s
``equal`` ... ``greater_equal``), for the Tensor's comparison operators
and bool-mask indexing."""

from __future__ import annotations

import torch

from .math import _make_binary

__all__ = []

equal = _make_binary("equal", torch.eq, __all__)
not_equal = _make_binary("not_equal", torch.ne, __all__)
less_than = _make_binary("less_than", torch.lt, __all__)
less_equal = _make_binary("less_equal", torch.le, __all__)
greater_than = _make_binary("greater_than", torch.gt, __all__)
greater_equal = _make_binary("greater_equal", torch.ge, __all__)
