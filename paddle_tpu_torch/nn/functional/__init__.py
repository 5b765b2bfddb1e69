"""Functional nn ops: ``linear``, ``embedding``, ``relu``, ``silu``,
``gelu``, ``tanh``, ``softmax``, ``log_softmax``, the other activations
(``activation.py``), ``cross_entropy``, ``layer_norm``, ``rms_norm``,
``batch_norm``, ``dropout``, ``scaled_dot_product_attention``, the
convolutions and their transposes (``conv.py``), the pools
(``pooling.py``), the other norms (``norm.py``), the losses
(``loss.py``), padding, resampling and the rest of JAX's common ops
(``common.py``) and the long tail with the flash-attention entry points
(``extras.py``): the whole of JAX's ``nn.functional``.

Counterpart of the same functions of ``paddle_tpu/nn/functional/``.  Two of
them reach the port's kernels through the op table
(``ops/dispatch.py``), by JAX's conditions:

* :func:`rms_norm` with a weight calls the ``rms_norm`` entry, the K9a /
  K9b wrapper: the kernels on a CUDA tensor, their plain versions on a CPU
  one (JAX takes its kernel whenever the backend is the accelerator).
  Without a weight it is the composite.
* :func:`scaled_dot_product_attention` follows :func:`sdpa_route`, on the
  type the AMP hook will give q (``ops.dispatch.amp_cast_dtype``).

and the varlen entry points (``extras.flash_attn_varlen_qkvpacked``,
``extras.flash_attn_unpadded``) call the segmented kernels' wrapper by
``extras.varlen_route``, as JAX's call its Pallas program directly.
The rest are plain torch ops under JAX's op names (``"gelu"``,
``"layer_norm"``, ``"batch_norm"``, ``"conv2d"``, ``"dropout"``,
``"dropout_id"``, ``"tanh"``, ...), so AMP's lists reach them: JAX has no
Pallas kernel for any of them.
:func:`dropout` draws its mask from the framework's generator of the
tensor's device (``framework/random.py``), never from torch's global
ones; the bits differ from ``jax.random``'s, the distribution does not.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...flags import flags
from ...framework import dtype as dtypes
from ...framework import random as framework_random
from ...ops.dispatch import amp_cast_dtype, apply, as_tensor, get_op_impl
from ...ops.flash_attention import causal_mask, kernel_takes, sdpa_plain
from ...tensor.math import tanh
from .activation import *  # noqa: F401,F403,E402
from .activation import __all__ as _activation_all
from .conv import (conv1d, conv1d_transpose, conv2d,  # noqa: F401
                   conv2d_transpose, conv3d, conv3d_transpose)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: F401
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, avg_pool1d, avg_pool2d,
                      avg_pool3d, max_pool1d, max_pool2d, max_pool3d)

__all__ = ["linear", "embedding", "relu", "silu", "gelu", "tanh", "softmax",
           "log_softmax", "cross_entropy", "layer_norm", "rms_norm",
           "batch_norm", "dropout", "scaled_dot_product_attention",
           "sdpa_route", "conv1d", "conv2d", "conv3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
           "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "conv1d_transpose", "conv2d_transpose",
           "conv3d_transpose", "adaptive_max_pool1d",
           "adaptive_max_pool2d"] + _activation_all


def relu(x, name=None):
    return apply("relu", torch.relu, as_tensor(x))


def silu(x, name=None):
    return apply("silu", TF.silu, as_tensor(x))


def gelu(x, approximate=False, name=None):
    """``x * Phi(x)``; ``approximate=True`` is the tanh form (JAX's
    ``jax.nn.gelu(approximate=True)``, torch's ``"tanh"``)."""
    mode = "tanh" if approximate else "none"
    return apply("gelu", lambda a: TF.gelu(a, approximate=mode),
                 as_tensor(x))


def softmax(x, axis=-1, dtype=None, name=None):
    tdt = dtypes.to_torch_dtype(dtype)

    def fn(a):
        return torch.softmax(a if tdt is None else a.to(tdt), dim=axis)

    return apply("softmax", fn, as_tensor(x))


def log_softmax(x, axis=-1, dtype=None, name=None):
    tdt = dtypes.to_torch_dtype(dtype)

    def fn(a):
        return torch.log_softmax(a if tdt is None else a.to(tdt), dim=axis)

    return apply("log_softmax", fn, as_tensor(x))


def linear(x, weight, bias=None, name=None):
    """``x @ W + b`` with W ``[in, out]`` (Paddle's layout)."""
    x, weight = as_tensor(x), as_tensor(weight)
    if bias is not None:
        return apply("linear", lambda a, w, b: torch.matmul(a, w) + b, x,
                     weight, as_tensor(bias))
    return apply("linear", torch.matmul, x, weight)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` [V, h] at ids ``x``; ids equal to
    ``padding_idx`` give zeros (JAX's rule: the output, not only the
    gradient)."""
    def fn(ids, w):
        out = TF.embedding(ids.long(), w)
        if padding_idx is not None:
            out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
        return out

    return apply("embedding", fn, as_tensor(x), as_tensor(weight))


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """JAX's ``cross_entropy``: hard or soft labels, ``ignore_index``
    masked out of the sum and of the mean's count, per-class ``weight``,
    ``label_smoothing``."""
    def reduce(loss):
        if reduction == "mean":
            return loss.mean()
        if reduction == "sum":
            return loss.sum()
        return loss

    def fn(logits, lab, *w):
        logp = torch.log_softmax(logits, dim=axis) if use_softmax else \
            torch.log(torch.clamp(logits, min=1e-30))
        nclass = logits.shape[axis]
        if soft_label or (lab.dim() == logits.dim() and
                          lab.shape[axis] == nclass and
                          lab.is_floating_point()):
            soft = lab
            if label_smoothing > 0:
                soft = soft * (1 - label_smoothing) + label_smoothing / nclass
            return reduce(-(soft * logp).sum(axis))
        idx = lab.long()
        if idx.dim() == logits.dim():
            idx = idx.squeeze(axis)
        mask = idx != ignore_index
        safe = torch.where(mask, idx, torch.zeros_like(idx))
        if label_smoothing > 0:
            oh = TF.one_hot(safe, nclass).movedim(-1, axis).to(logp.dtype)
            oh = oh * (1 - label_smoothing) + label_smoothing / nclass
            loss = -(oh * logp).sum(axis)
        else:
            loss = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
        loss = torch.where(mask, loss, torch.zeros_like(loss))
        if w:
            wt = w[0][safe]
            loss = loss * wt
            if reduction == "mean":
                return loss.sum() / torch.clamp((wt * mask).sum(), min=1e-12)
        if reduction == "mean":
            return loss.sum() / torch.clamp(mask.sum(), min=1)
        return reduce(loss)

    args = [as_tensor(input), as_tensor(label)]
    if weight is not None:
        args.append(as_tensor(weight))
    return apply("cross_entropy", fn, *args)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last axis.  With a weight: the ``rms_norm`` op
    table entry (the K9 wrapper: ``x`` reshaped to rows and back, f32
    inside, the output in ``promote(x, w)``).  Without one: JAX's
    composite, ``x * rstd`` rounded to x's type."""
    x = as_tensor(x)
    impl = get_op_impl("rms_norm", None)
    if impl is not None and weight is not None:
        return apply("rms_norm", lambda a, w: impl(a, w, epsilon), x,
                     as_tensor(weight))

    def fn(a, *w):
        af = a.float()
        var = torch.mean(af * af, -1, keepdim=True)
        out = (af * torch.rsqrt(var + epsilon)).to(a.dtype)
        return out * w[0] if w else out

    if weight is not None:
        return apply("rms_norm", fn, x, as_tensor(weight))
    return apply("rms_norm", fn, x)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Normalise over the trailing ``normalized_shape`` axes with the
    population variance, then ``* weight + bias``.  When x, weight and
    bias share one type this is torch's ``layer_norm`` (the same math in
    one pass); otherwise JAX's composite, whose products promote (a bf16
    x with f32 weights gives f32)."""
    x = as_tensor(x)
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    shape = [int(d) for d in normalized_shape]
    axes = tuple(range(x.ndim - len(shape), x.ndim))
    has_w, has_b = weight is not None, bias is not None

    def fn(a, *wb):
        w = wb[0] if has_w else None
        b = wb[-1] if has_b else None
        if all(t is None or t.dtype == a.dtype for t in (w, b)):
            return TF.layer_norm(a, shape, w, b, epsilon)
        m = a.mean(axes, keepdim=True)
        v = a.var(axes, unbiased=False, keepdim=True)
        out = (a - m) / torch.sqrt(v + epsilon)
        if w is not None:
            out = out * w
        return out + b if b is not None else out

    args = [x]
    if has_w:
        args.append(as_tensor(weight))
    if has_b:
        args.append(as_tensor(bias))
    return apply("layer_norm", fn, *args)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """JAX's ``batch_norm``.  The statistics are over every axis but the
    channel's (axis 1, or the last one for a channel-last
    ``data_format``):

    * it normalises with the running statistics when ``use_global_stats``
      says so, else when not ``training``; otherwise with the batch's mean
      and *biased* variance;
    * in training (whatever ``use_global_stats`` says, as in JAX) it
      rebinds the running buffers to ``momentum * old + (1 - momentum) *
      batch``, with the *unbiased* batch variance.  Paddle's ``momentum``
      is the share of the old statistic: torch's ``momentum`` (the new
      share) is ``1 - momentum``.

    The buffers are rebound, not written in place (JAX's rule, which
    ``incubate.jit_train_step`` relies on: its warm-up run must leave them
    as they were).  The op is ``"batch_norm"``, on AMP's f32 list, so under
    O1 it normalises and takes the batch statistics in f32."""
    x = as_tensor(x)
    ch_last = not (data_format[1] == "C" or data_format == "NC")
    use_stats = (not training) if use_global_stats is None else \
        use_global_stats
    update = training and running_mean is not None
    stats = [] if running_mean is None else [as_tensor(running_mean),
                                             as_tensor(running_var)]
    new = {}

    def fn(a, *rest):
        m, v = rest[:2] if stats else (None, None)
        wb = rest[len(stats):]
        if ch_last:
            a = a.movedim(-1, 1)
        w = wb[0] if weight is not None else None
        b = wb[-1] if bias is not None else None
        if use_stats:
            out = TF.batch_norm(a, m, v, w, b, False, 0.0, epsilon)
        if update:
            nm = m.detach().clone()
            nv = v.detach().clone()
            if use_stats:
                TF.batch_norm(a.detach(), nm, nv, None, None, True,
                              1.0 - momentum, epsilon)
            else:
                out = TF.batch_norm(a, nm, nv, w, b, True, 1.0 - momentum,
                                    epsilon)
            new["mean"], new["var"] = nm, nv
        elif not use_stats:
            out = TF.batch_norm(a, None, None, w, b, True, 0.0, epsilon)
        return out.movedim(1, -1) if ch_last else out

    args = [x] + stats
    if weight is not None:
        args.append(as_tensor(weight))
    if bias is not None:
        args.append(as_tensor(bias))
    out = apply("batch_norm", fn, *args)
    if update:
        running_mean._data = new["mean"].to(running_mean._data.dtype)
        running_var._data = new["var"].to(running_var._data.dtype)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element (or each slice along ``axis``: the mask has size 1
    on every other axis) with probability ``p``.  ``upscale_in_train``
    scales the kept ones by 1 / (1 - p) in training and is the identity
    in inference; ``downscale_in_infer`` keeps them as they are in
    training and scales by 1 - p in inference."""
    x = as_tensor(x)
    if not training or p == 0:
        if mode == "downscale_in_infer" and not training:
            return apply("dropout", lambda a: a * (1.0 - p), x)
        return apply("dropout_id", lambda a: a, x)
    gen = framework_random.generator(x._data.device)
    scale = (0.0 if p >= 1 else 1.0 / (1.0 - p)) \
        if mode == "upscale_in_train" else 1.0

    def fn(a):
        shape = list(a.shape)
        if axis is not None:
            ax = [axis] if isinstance(axis, int) else list(axis)
            ax = [i % a.dim() for i in ax]
            shape = [s if i in ax else 1 for i, s in enumerate(shape)]
        keep = torch.rand(shape, generator=gen, device=a.device) >= p
        kept = a * scale if scale != 1.0 else a
        return torch.where(keep, kept, torch.zeros((), dtype=a.dtype,
                                                   device=a.device))

    return apply("dropout", fn, x)


def _pick_block(s: int):
    """JAX's ``_pick_blocks``: the largest power-of-two block <= 512 that
    divides ``s``, or None when no block >= 8 does."""
    for b in (512, 256, 128, 64, 32, 16, 8):
        if s % b == 0:
            return b
    return None


def sdpa_route(q, k, attn_mask=None, dropout_p=0.0, dtype=None) -> str:
    """Which attention :func:`scaled_dot_product_attention` runs for q / k
    ``[b, s, h, d]`` data, decided from shapes, types and the device
    before anything launches.  ``dtype`` is the type the op will run in
    (the AMP hook's cast of q's; q's own when None):

    * ``"composite"``: no ``flash_attention`` entry in the op table,
      ``FLAGS_pallas_flash_attention`` off, a mask or dropout (JAX's
      conditions) -- the einsum composite in the inputs' type;
    * ``"plain"``: JAX's flash wrapper sends these to its XLA attention
      (``_xla_sdpa``): ``q_len != kv_len`` (decode shapes), unequal head
      counts, or a length no power-of-two block >= 8 divides.  The port
      adds one condition of its own: on a CUDA tensor, inputs the kernels
      do not take (``ops.flash_attention.kernel_takes``: a type other than
      bf16 or a head_dim other than 64 / 128; JAX sends f32 into its
      kernel; ROADMAP.md queue 3).  This route is
      ``ops.flash_attention.sdpa_plain``, the same f32 math;
    * ``"flash"``: the rest, the flash attention kernels (K6a forward,
      K6b / K6c backward) on the card, their plain versions on the CPU.
    """
    impl = get_op_impl("flash_attention", None)
    if impl is None or not flags.FLAGS_pallas_flash_attention or \
            attn_mask is not None or dropout_p != 0.0:
        return "composite"
    if q.shape[1] != k.shape[1] or q.shape[2] != k.shape[2] or \
            _pick_block(q.shape[1]) is None:
        return "plain"
    if q.device.type == "cuda" and not kernel_takes(q, dtype):
        return "plain"
    return "flash"


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """q / k / v ``[batch, seq, heads, dim]``; routed by
    :func:`sdpa_route`.  A causal mask is end-aligned (a 1-token query
    sees the whole cache); ``q_len > kv_len`` with ``is_causal`` raises.
    ``dropout_p`` drops elements of the attention's output in training, as
    JAX does (not the probabilities); any ``dropout_p`` takes the
    composite."""
    q, k, v = as_tensor(query), as_tensor(key), as_tensor(value)
    if is_causal:
        causal_mask(q.shape[1], k.shape[1])
    route = sdpa_route(q._data, k._data, attn_mask, dropout_p,
                       amp_cast_dtype("flash_attention", q._data.dtype))
    if route == "flash":
        impl = get_op_impl("flash_attention", None)
        return apply("flash_attention",
                     lambda qq, kk, vv: impl(qq.contiguous(), kk.contiguous(),
                                             vv.contiguous(),
                                             causal=is_causal),
                     q, k, v)
    if route == "plain":
        return apply("flash_attention",
                     lambda qq, kk, vv: sdpa_plain(qq, kk, vv, is_causal),
                     q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])

    def fn(qq, kk, vv, *mask):
        qq, kk, vv = (t.transpose(1, 2) for t in (qq, kk, vv))
        logits = torch.einsum("bhqd,bhkd->bhqk", qq, kk) * scale
        if is_causal:
            cm = causal_mask(logits.shape[-2], logits.shape[-1],
                             logits.device)
            logits = logits.masked_fill(~cm, -math.inf)
        if mask:
            m = mask[0]
            logits = logits.masked_fill(~m, -math.inf) \
                if m.dtype == torch.bool else logits + m
        probs = torch.softmax(logits.float(), dim=-1).to(vv.dtype)
        return torch.einsum("bhqk,bhkd->bhqd", probs, vv).transpose(1, 2)

    if attn_mask is not None:
        out = apply("sdpa", fn, q, k, v, as_tensor(attn_mask))
    else:
        out = apply("sdpa", fn, q, k, v)
    if dropout_p > 0.0 and training:
        out = dropout(out, p=dropout_p, training=training)
    return out


from .common import *  # noqa: F401,F403,E402
from .common import __all__ as _common_all  # noqa: E402
from .extras import *  # noqa: F401,F403,E402
from .extras import __all__ as _extras_all  # noqa: E402
from .loss import *  # noqa: F401,F403,E402
from .loss import __all__ as _loss_all  # noqa: E402
from .norm import *  # noqa: F401,F403,E402
from .norm import __all__ as _norm_all  # noqa: E402

__all__ += _common_all + _norm_all + _loss_all + _extras_all
