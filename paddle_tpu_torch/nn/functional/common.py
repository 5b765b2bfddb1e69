"""The rest of nn.functional's common ops: ``bilinear``, ``dropout2d`` /
``dropout3d`` / ``alpha_dropout``, ``one_hot``, ``pad``, ``interpolate``
(``upsample``, ``linear_interp``), the pixel and channel shuffles,
``unfold`` / ``fold``, ``affine_grid``, ``grid_sample``,
``cosine_similarity`` and ``sequence_mask``.

Counterpart of those functions of ``paddle_tpu/nn/functional/__init__.py``,
whose results these keep where they depart from Paddle's:

* ``pad`` with fewer pairs than twice the rank pads the trailing spatial
  axes in order (the first pair the first of them); ``reflect`` /
  ``replicate`` / ``circular`` are numpy's ``reflect`` / ``edge`` /
  ``wrap`` on any axis (an index gather here, so any rank and pad width);
* ``interpolate`` is ``jax.image.resize``: half-pixel centres whatever
  ``align_corners`` says; ``nearest`` takes ``floor((i + 0.5) * in / out)``;
  ``bilinear`` / ``trilinear`` / ``linear`` / ``area`` the triangle kernel
  and ``bicubic`` Keys' cubic (a = -0.5), each widened by ``in / out`` when
  it shrinks an axis (antialiasing) and normalised; here each axis is one
  product with that weight matrix, built in f64 as JAX builds it;
* ``grid_sample`` clamps every corner index into the image (whatever
  ``padding_mode`` says) and weighs it by the unclamped coordinates;
  ``nearest`` rounds half to even;
* ``one_hot`` gives zero rows for labels outside ``[0, num_classes)``.

JAX has no Pallas kernel for any of them: each is torch ops on the card.
The dropouts draw their masks from the framework's generator of the
tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...framework import dtype as dtypes
from ...framework import random as framework_random
from ...ops.dispatch import apply, as_tensor
from ...tensor.tensor import Tensor
from . import dropout
from .conv import _norm_tuple

__all__ = ["bilinear", "dropout2d", "dropout3d", "alpha_dropout", "one_hot",
           "pad", "interpolate", "upsample", "linear_interp",
           "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "unfold",
           "fold", "affine_grid", "grid_sample", "cosine_similarity",
           "sequence_mask"]


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ W[o] @ x2[b] (+ bias[o])``, W ``[out, in1,
    in2]``."""
    def fn(a, b, w, *bb):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        return out + bb[0] if bb else out

    args = [as_tensor(x1), as_tensor(x2), as_tensor(weight)]
    if bias is not None:
        args.append(as_tensor(bias))
    return apply("bilinear", fn, *args)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels dropped: the mask varies over N and C alone."""
    axes = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axes, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axes = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axes, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout: dropped elements set to ``-alpha * scale``, then an
    affine map that keeps the mean and the variance."""
    x = as_tensor(x)
    if not training or p == 0:
        return apply("alpha_dropout_id", lambda a: a, x)
    gen = framework_random.generator(x._data.device)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    q = 1.0 - p
    a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
    b_coef = -a_coef * alpha_p * p

    def fn(a):
        keep = torch.rand(a.shape, generator=gen, device=a.device) >= p
        out = a_coef * torch.where(keep, a, torch.full(
            (), alpha_p, dtype=a.dtype, device=a.device)) + b_coef
        return out.to(a.dtype)

    return apply("alpha_dropout", fn, x)


def one_hot(x, num_classes, name=None):
    """f32 ``[..., num_classes]``."""
    def fn(a):
        cls = torch.arange(num_classes, device=a.device)
        return (a.long()[..., None] == cls).to(torch.float32)

    return apply("one_hot", fn, as_tensor(x))


def _pad_pairs(pad, ndim, data_format):
    if isinstance(pad, int):
        return [(pad, pad)] * ndim
    if len(pad) == 2 * ndim:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(ndim)]
    nsp = len(pad) // 2
    pairs = [(0, 0)] * ndim
    start = 1 if data_format.endswith("C") else ndim - nsp
    for i in range(nsp):
        pairs[start + i] = (pad[2 * i], pad[2 * i + 1])
    return pairs


def _pad_index(n, lo, hi, mode, device):
    """The source index of each of ``lo + n + hi`` cells along an axis."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i % n
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = i % period
    return torch.where(j < n, j, period - j)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    x = as_tensor(x)
    if isinstance(pad, Tensor):
        pad = pad.tolist()
    if not isinstance(pad, int):
        pad = [int(p) for p in pad]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode {mode!r}")

    def fn(a):
        pairs = _pad_pairs(pad, a.dim(), data_format)
        if mode == "constant":
            return TF.pad(a, [v for lo, hi in reversed(pairs)
                              for v in (lo, hi)], value=value)
        for axis, (lo, hi) in enumerate(pairs):
            if lo or hi:
                a = a.index_select(axis, _pad_index(a.shape[axis], lo, hi,
                                                    mode, a.device))
        return a

    return apply("pad", fn, x)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1 - x.abs(), min=0.0)


def _resize_weights(m, n, kernel, device):
    """jax.image's ``compute_weight_mat`` (scale n / m, no translation,
    antialiased) in f64 -> [m, n]."""
    inv = m / n
    kscale = max(inv, 1.0)
    sample = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) \
        * inv - 0.5
    src = torch.arange(m, dtype=torch.float64, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kscale)
    tot = w.sum(0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    x = as_tensor(x)
    nd = x.ndim - 2
    in_sp = x.shape[2:]
    if size is not None:
        if isinstance(size, Tensor):
            size = size.tolist()
        out_sp = [int(s.item()) if isinstance(s, Tensor) else int(s)
                  for s in (size if isinstance(size, (list, tuple))
                            else [size])]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else \
            [scale_factor] * nd
        out_sp = [int(i * s) for i, s in zip(in_sp, sf)]
    kinds = {"nearest": None, "bilinear": _triangle, "trilinear": _triangle,
             "linear": _triangle, "area": _triangle, "bicubic": _keys_cubic}
    if mode not in kinds:
        raise ValueError(f"unknown interpolate mode {mode!r}")
    kernel = kinds[mode]

    def fn(a):
        for d, (m, n) in enumerate(zip(in_sp, out_sp)):
            axis = 2 + d
            if m == n:
                continue
            if kernel is None:
                idx = torch.floor((torch.arange(n, dtype=torch.float32,
                                                device=a.device) + 0.5)
                                  * m / n).long()
                a = a.index_select(axis, idx)
                continue
            w = _resize_weights(m, n, kernel, a.device).to(a.dtype)
            a = torch.tensordot(a, w, dims=([axis], [0])).movedim(-1, axis)
        return a

    return apply("interpolate", fn, x)


upsample = interpolate
linear_interp = interpolate


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return apply("pixel_shuffle",
                 lambda a: TF.pixel_shuffle(a, upscale_factor), as_tensor(x))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return apply("pixel_unshuffle",
                 lambda a: TF.pixel_unshuffle(a, downscale_factor),
                 as_tensor(x))


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def fn(a):
        n, c, h, w = a.shape
        return a.reshape(n, groups, c // groups, h, w).transpose(
            1, 2).reshape(n, c, h, w)

    return apply("channel_shuffle", fn, as_tensor(x))


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """[N, C, H, W] -> [N, C * kh * kw, L] (im2col; channel-major rows)."""
    k, s = _norm_tuple(kernel_sizes, 2), _norm_tuple(strides, 2)
    p, d = _norm_tuple(paddings, 2), _norm_tuple(dilations, 2)
    return apply("unfold", lambda a: TF.unfold(a, k, d, p, s), as_tensor(x))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """unfold's adjoint: overlapping patches summed."""
    o = _norm_tuple(output_sizes, 2)
    k, s = _norm_tuple(kernel_sizes, 2), _norm_tuple(strides, 2)
    p, d = _norm_tuple(paddings, 2), _norm_tuple(dilations, 2)
    return apply("fold", lambda a: TF.fold(a, o, k, d, p, s), as_tensor(x))


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """[N, 2, 3] affine maps -> [N, H, W, 2] sampling grids (x, y)."""
    theta = as_tensor(theta)
    if isinstance(out_shape, Tensor):
        out_shape = [int(v) for v in out_shape.tolist()]
    n, _, h, w = out_shape

    def axis(k, th):
        if align_corners:
            return torch.linspace(-1, 1, k, dtype=th.dtype, device=th.device)
        return (torch.arange(k, dtype=th.dtype, device=th.device) + 0.5) \
            * 2 / k - 1

    def fn(th):
        gy, gx = torch.meshgrid(axis(h, th), axis(w, th), indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(-1, 3)
        return (base @ th.transpose(-1, -2)).reshape(th.shape[0], h, w, 2)

    return apply("affine_grid", fn, theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """x [N, C, H, W] sampled at grid [N, Ho, Wo, 2] (x, y in [-1, 1])."""
    def fn(a, g):
        n, c, h, w = a.shape
        if align_corners:
            gx = (g[..., 0] + 1) * (w - 1) / 2
            gy = (g[..., 1] + 1) * (h - 1) / 2
        else:
            gx = ((g[..., 0] + 1) * w - 1) / 2
            gy = ((g[..., 1] + 1) * h - 1) / 2
        flat = a.reshape(n, c, h * w)

        def sample(yy, xx):
            yy = yy.clamp(0, h - 1).long()
            xx = xx.clamp(0, w - 1).long()
            idx = (yy * w + xx).reshape(n, 1, -1).expand(n, c, -1)
            return flat.gather(2, idx).reshape(n, c, *yy.shape[1:])

        if mode == "nearest":
            return sample(torch.round(gy), torch.round(gx))
        x0, y0 = torch.floor(gx), torch.floor(gy)
        x1, y1 = x0 + 1, y0 + 1
        wa = ((x1 - gx) * (y1 - gy))[:, None]
        wb = ((gx - x0) * (y1 - gy))[:, None]
        wc = ((x1 - gx) * (gy - y0))[:, None]
        wd = ((gx - x0) * (gy - y0))[:, None]
        return (wa * sample(y0, x0) + wb * sample(y0, x1) +
                wc * sample(y1, x0) + wd * sample(y1, x1))

    return apply("grid_sample", fn, as_tensor(x), as_tensor(grid))


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def fn(a, b):
        den = torch.linalg.vector_norm(a, dim=axis) * \
            torch.linalg.vector_norm(b, dim=axis)
        return (a * b).sum(axis) / torch.clamp(den, min=eps)

    return apply("cosine_similarity", fn, as_tensor(x1), as_tensor(x2))


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < x[...]``; ``maxlen`` defaults to ``max(x)`` (a
    read of the device)."""
    x = as_tensor(x)
    ml = int(maxlen) if maxlen is not None else int(x.max().item())
    tdt = dtypes.to_torch_dtype(dtype)
    return apply("sequence_mask",
                 lambda a: (torch.arange(ml, device=a.device) <
                            a[..., None]).to(tdt), x)

