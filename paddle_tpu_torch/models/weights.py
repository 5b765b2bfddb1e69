"""Load the JAX param tree and optimizer state into the port.

:func:`params_from_jax` turns the tree ``paddle_tpu``'s LLaMA code uses
(``embed``, the stacked ``blocks[L, ...]``, ``final_norm``, ``lm_head``),
given as numpy arrays or anything ``numpy.asarray`` accepts, into the port's
params: the same nesting, layout and values, as torch tensors on a device.
This is how the tests give both packages the same weights.
:func:`opt_state_from_jax` does the same for an optimizer state
(``{"t", "moments"}`` of AdamW or Adafactor), so that both packages can
start a training step from the same state.

For the Layer API: :func:`layer_state_from_jax` loads a JAX Layer model's
``state_dict()`` (JAX's dotted names, numpy arrays or anything with
``.numpy()``) into the port's Layer model of the same config, and
:func:`causal_lm_from_params` builds the port's ``LlamaForCausalLM`` over a
functional params tree without copying it: each parameter is a view of
one layer's slice of the stacked ``[L, ...]`` tensors.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["params_from_jax", "opt_state_from_jax", "layer_state_from_jax",
           "causal_lm_from_params"]


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


def layer_state_from_jax(model, state) -> None:
    """Load a JAX Layer model's ``state_dict()`` into the port's ``model``
    (same names and shapes): each value cast to the port parameter's type
    and kept on its device.  Raises on a name either side lacks."""
    arrays = {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
              for k, v in state.items()}
    missing, unexpected = model.set_state_dict(arrays)
    if missing or unexpected:
        raise KeyError(f"state_dict names differ: missing {missing}, "
                       f"unexpected {unexpected}")


def causal_lm_from_params(params, cfg):
    """The port's ``LlamaForCausalLM`` for ``cfg`` (an untied
    ``LlamaConfig``) over the functional ``params`` (``embed``, stacked
    ``blocks``, ``final_norm``, ``lm_head``, on any device): no parameter
    is drawn or copied, each is a view of ``params`` (layer ``i``'s
    weights are ``blocks[name][i]``), so writing one writes the other."""
    from ..nn.layer.layers import deferred_init
    from .llama import LlamaForCausalLM, _NAMES
    if cfg.tie_word_embeddings:
        raise ValueError("the functional params have their own lm_head; "
                         "build an untied config")
    with deferred_init():
        model = LlamaForCausalLM(cfg)

    def put(param, data):
        if tuple(data.shape) != tuple(param.shape):
            raise ValueError(f"{tuple(data.shape)} != {param.shape}")
        keep = param.stop_gradient
        param._data = data.detach()
        param.stop_gradient = keep

    blocks = params["blocks"]
    for i, layer in enumerate(model.llama.layers):
        for name, get in _NAMES.items():
            put(get(layer), blocks[name][i])
    put(model.llama.embed_tokens.weight, params["embed"])
    put(model.llama.norm.weight, params["final_norm"])
    put(model.lm_head.weight, params["lm_head"])
    return model
