"""Load the JAX param tree into the port.

:func:`params_from_jax` turns the tree ``paddle_tpu``'s LLaMA code uses
(``embed``, the stacked ``blocks[L, ...]``, ``final_norm``, ``lm_head``),
given as numpy arrays or anything ``numpy.asarray`` accepts, into the port's
params: the same nesting, layout and values, as torch tensors on a device.
This is how the tests give both packages the same weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(tree: Any, device=None) -> Any:
    """Nested dicts of arrays -> the same dicts of tensors on ``device``
    (CUDA unless asked otherwise), bit for bit."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)
