"""The tensor-parallel seam of the Layer models (counterpart of
``paddle_tpu/models/_layers.py:make_tp_linear``).

JAX builds column / row-parallel layers when a global mesh has an ``mp``
axis above 1, and a plain ``Linear`` otherwise.  The port has no mesh yet:
a plain ``Linear`` when no process group spans more than one rank (JAX's
case without a mesh), and ``NotImplementedError`` inside one that does
(ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import torch.distributed as dist

from ..nn import Linear

__all__ = ["make_tp_linear"]


def make_tp_linear(tensor_parallel: bool, in_f: int, out_f: int, kind: str,
                   has_bias: bool = False):
    if tensor_parallel and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"tensor-parallel {kind} linear layers are not ported yet "
            f"(ROADMAP.md queue 1 item 7)")
    return Linear(in_f, out_f, bias_attr=None if has_bias else False)
