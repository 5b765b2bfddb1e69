"""The seams the Layer models share (counterpart of
``paddle_tpu/models/_layers.py``): :func:`make_tp_linear` and
:func:`normalize_attn_mask`.

JAX builds column / row-parallel layers when a global mesh has an ``mp``
axis above 1, and a plain ``Linear`` otherwise.  The port has no mesh yet:
a plain ``Linear`` when no process group spans more than one rank (JAX's
case without a mesh), and ``NotImplementedError`` inside one that does
(ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..nn import Linear
from ..ops.dispatch import apply, as_tensor

__all__ = ["make_tp_linear", "normalize_attn_mask"]


def make_tp_linear(tensor_parallel: bool, in_f: int, out_f: int, kind: str,
                   has_bias: bool = False):
    if tensor_parallel and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"tensor-parallel {kind} linear layers are not ported yet "
            f"(ROADMAP.md queue 1 item 7)")
    return Linear(in_f, out_f, bias_attr=None if has_bias else False)


def normalize_attn_mask(mask, neg: float = -1e9):
    """A mask in one of the usual forms -> what
    ``scaled_dot_product_attention`` takes ([B, 1|H, L, L] bool or
    additive float):

    * [B, L] 0/1 padding mask (PaddleNLP's) -> additive f32 [B, 1, 1, L]
      with ``neg`` at padded keys;
    * [B, L, L] bool or float -> [B, 1, L, L];
    * a 4-D mask passes unchanged.
    """
    if mask is None:
        return None
    m = as_tensor(mask)
    if m.ndim == 2:
        return apply("attn_mask_pad",
                     lambda a: ((1.0 - a.to(torch.float32)) * neg)[
                         :, None, None, :], m)
    if m.ndim == 3:
        return apply("attn_mask_3d", lambda a: a[:, None, :, :], m)
    return m
