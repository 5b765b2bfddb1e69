"""Fused functional ops: ``fused_rotary_position_embedding``, ``swiglu``
and ``fused_rms_norm``.

Counterpart of the same functions of
``paddle_tpu/incubate/nn/functional/``, on the port's kernels by JAX's
conditions:

* ``fused_rotary_position_embedding`` takes the ``fused_rope`` op table
  entry (K5: forward, and ``-sin`` in the backward) under
  ``FLAGS_pallas_rope`` for the rotate-half style, no ``position_ids``, no
  given tables and ``head_dim % 128 == 0``; the tables are
  ``ops.rope.cached_tables``, built once for every layer.  Otherwise the
  composite ``x * cos + rotate(x) * sin`` in x's type, over tables at the
  given positions (the ``position_ids`` lane of a decode step stays
  composite, as in JAX).
* ``swiglu`` takes the ``swiglu`` entry (K10a / K10b) under
  ``FLAGS_pallas_swiglu``, else ``silu(x) * y``.
* ``fused_rms_norm`` is ``nn.functional.rms_norm`` (K9a / K9b) plus an
  optional bias, returned as a 1-tuple.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from ....flags import flags
from ....ops.dispatch import apply, as_tensor, get_op_impl
from ....ops.rope import cached_tables, rope_inv_freq, rope_tables

__all__ = ["fused_rms_norm", "fused_rotary_position_embedding", "swiglu"]


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, **kw):
    from ....nn.functional import rms_norm
    from ....tensor.math import add
    out = rms_norm(x, norm_weight, epsilon=epsilon)
    if norm_bias is not None:
        out = add(out, norm_bias)
    return (out,)


def _rope_one(x, sin_e, cos_e, neox):
    """x [b, s, h, d] by tables [s, d] (shared) or [b, s, d]."""
    d = x.shape[-1]
    if neox:
        rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    else:
        rot = torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(
            x.shape)

    def expand(t):
        return t[None, :, None, :] if t.dim() == 2 else t[:, :, None, :]

    return x * expand(cos_e) + rot * expand(sin_e)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False, rotary_emb_base=10000):
    """Rotary embedding of q (and k, v) ``[b, s, h, d]``; returns a
    3-tuple with None where an input was None."""
    ins = [as_tensor(t) for t in (q, k, v) if t is not None]
    theta = float(rotary_emb_base)

    def fn(*arrs):
        a0 = arrs[0]
        s, d = a0.shape[1], a0.shape[-1]
        impl = get_op_impl("fused_rope", None)
        if (impl is not None and flags.FLAGS_pallas_rope and
                use_neox_rotary_style and position_ids is None and
                sin is None and d % 128 == 0):
            cos_t, sin_t = cached_tables(s, d, theta, device=a0.device)
            return tuple(impl(a.contiguous(), cos_t, sin_t) for a in arrs)
        if sin is None:
            if position_ids is not None:
                pos = as_tensor(position_ids)._data.to(a0.device)
                inv = rope_inv_freq(d, theta, device=a0.device)
                freqs = pos.to(torch.float32)[..., None] * inv
                emb = torch.cat([freqs, freqs], dim=-1)
                sin_e, cos_e = torch.sin(emb), torch.cos(emb)
            else:
                cos_h, sin_h = rope_tables(s, d, theta, device=a0.device)
                sin_e = torch.cat([sin_h, sin_h], -1)
                cos_e = torch.cat([cos_h, cos_h], -1)
            sin_e, cos_e = sin_e.to(a0.dtype), cos_e.to(a0.dtype)
        else:
            sin_e = as_tensor(sin)._data.reshape(s, d)
            cos_e = as_tensor(cos)._data.reshape(s, d)
        return tuple(_rope_one(a, sin_e, cos_e, use_neox_rotary_style)
                     for a in arrs)

    outs = apply("fused_rope", lambda *a: tuple(fn(*a)), *ins)
    it = iter(outs)
    return tuple(next(it) if t is not None else None for t in (q, k, v))


def swiglu(x, y=None, name=None):
    """``silu(x) * y``, or of the two halves of x's last axis."""
    impl = get_op_impl("swiglu", None)
    use_kernel = impl is not None and flags.FLAGS_pallas_swiglu
    if y is None:
        def fn(a):
            a1, a2 = torch.chunk(a, 2, dim=-1)
            return impl(a1, a2) if use_kernel else TF.silu(a1) * a2
        return apply("swiglu", fn, as_tensor(x))
    if use_kernel:
        return apply("swiglu", impl, as_tensor(x), as_tensor(y))
    return apply("swiglu", lambda a, b: TF.silu(a) * b, as_tensor(x),
                 as_tensor(y))
