"""Load the JAX param tree and optimizer state into the port.

:func:`params_from_jax` turns the tree ``paddle_tpu``'s LLaMA code uses
(``embed``, the stacked ``blocks[L, ...]``, ``final_norm``, ``lm_head``),
given as numpy arrays or anything ``numpy.asarray`` accepts, into the port's
params: the same nesting, layout and values, as torch tensors on a device.
This is how the tests give both packages the same weights.
:func:`opt_state_from_jax` does the same for an optimizer state
(``{"t", "moments"}`` of AdamW or Adafactor), so that both packages can
start a training step from the same state.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["params_from_jax", "opt_state_from_jax"]


def params_from_jax(tree: Any, device=None) -> Any:
    """Nested dicts of arrays -> the same dicts of tensors on ``device``
    (CUDA unless asked otherwise), bit for bit."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.array(x, copy=True)
        if a.dtype.name == "bfloat16":
            # numpy's bfloat16 is an extension type torch does not read:
            # hand the bits over
            return torch.from_numpy(a.view(np.uint16)).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    return conv(tree)


def opt_state_from_jax(state: Any, device=None) -> Any:
    """An optimizer state of the JAX package (``init_adamw_state`` /
    ``init_adafactor_state`` or a step's result, as arrays or numpy) -> the
    port's: ``t`` as an int, ``moments`` as the same nesting of tensors on
    ``device`` (CUDA unless asked otherwise), bit for bit."""
    return {"t": int(np.asarray(state["t"])),
            "moments": params_from_jax(state["moments"], device)}
