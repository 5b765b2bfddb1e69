"""Long-tail nn functionals (counterpart of
``paddle_tpu/nn/functional/extras.py``): distances and label ops, the pool
variants (with index, unpools, power-average, adaptive 3-D max,
fractional), the long-tail losses, the beam-search backtrace, the
extension ops and the flash-attention entry points.

The flash entry points reach the port's kernels:

* ``flash_attn_qkvpacked`` is ``scaled_dot_product_attention`` on the
  packed q / k / v, routed by ``F.sdpa_route`` (K6a forward, K6b / K6c
  backward at bf16 with head_dim 64 or 128 on the card);
* ``flash_attn_varlen_qkvpacked`` and ``flash_attn_unpadded`` run the whole
  packed batch as one ``ops.flash_varlen.flash_attention_segmented`` call
  (K2 and its tile-range kernel forward, K7a / K7b backward), as JAX runs
  one segment-aware Pallas program: ``cu_seqlens`` become segment ids, the
  stream is padded to a multiple of 128 rows (128 when shorter) with
  segment id -1, and the padding rows are sliced off (they attend among
  themselves alone, so the real rows' outputs and gradients do not see
  them).  GQA stays native (nkv dividing n; K and V are never repeated).
  A caller's ``scale`` pre-scales q by ``scale * sqrt(d)``, as in JAX.
  :func:`varlen_route` decides, before anything launches, between the
  kernels and ``segmented_sdpa_docs`` (the same f32 math, a document at a
  time) by the type the op runs in and the head size;
* ``dropout > 0``, or ``cu_seqlens_q != cu_seqlens_k`` in
  ``flash_attn_unpadded``, take JAX's per-sequence loop through
  ``scaled_dot_product_attention``.

``flash_attention_with_sparse_mask``, ``sparse_attention``, the losses,
the pools and the rest are XLA ops in JAX (no Pallas kernel) and torch ops
here.  Random draws (``fractional_max_pool*`` without ``random_u``,
``class_center_sample``) come from the framework's generator of the
current place; the bits differ from ``jax.random``'s.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...framework import place as places
from ...framework import random as framework_random
from ...ops import flash_attention as _fa
from ...ops.dispatch import amp_cast_dtype, apply, as_tensor
from ...tensor.manipulation import concat, repeat_interleave
from ...tensor.tensor import Tensor, wrap_array
from . import scaled_dot_product_attention
from .conv import _norm_tuple
from .pooling import (_AVG, _adaptive_max, _ceil_extra, _flat_pads,
                      _max_pool)

__all__ = [
    "pairwise_distance", "label_smooth", "zeropad2d",
    "lp_pool1d", "lp_pool2d", "adaptive_max_pool3d",
    "max_pool2d_with_index", "max_unpool1d", "max_unpool2d", "max_unpool3d",
    "fractional_max_pool2d", "fractional_max_pool3d",
    "dice_loss", "poisson_nll_loss", "npair_loss",
    "multi_label_soft_margin_loss", "hsigmoid_loss", "margin_cross_entropy",
    "multi_margin_loss", "triplet_margin_with_distance_loss",
    "gaussian_nll_loss", "gather_tree", "rnnt_loss",
    "temporal_shift", "class_center_sample", "sparse_attention",
    "adaptive_log_softmax_with_loss", "flash_attn_qkvpacked",
    "flash_attn_varlen_qkvpacked", "flash_attn_unpadded",
    "flash_attention_with_sparse_mask", "varlen_route",
]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


# ---------------------------------------------------------------------------
# distances / label ops / padding
# ---------------------------------------------------------------------------
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``||x - y + epsilon||_p`` along the last axis."""
    def fn(a, b):
        d = (a - b + epsilon).abs()
        if p == float("inf"):
            return d.amax(-1, keepdim=keepdim)
        return (d ** p).sum(-1, keepdim=keepdim) ** (1.0 / p)

    return apply("pairwise_distance", fn, as_tensor(x), as_tensor(y))


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) * label + epsilon * prior`` (uniform by default)."""
    if prior_dist is not None:
        return apply("label_smooth",
                     lambda lab, d: (1.0 - epsilon) * lab + epsilon * d,
                     as_tensor(label), as_tensor(prior_dist))
    return apply("label_smooth",
                 lambda lab: (1.0 - epsilon) * lab + epsilon / lab.shape[-1],
                 as_tensor(label))


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """``padding`` = [left, right, top, bottom]."""
    p = _norm_tuple(padding, 4)

    def fn(a):
        if data_format == "NCHW":
            return TF.pad(a, [p[0], p[1], p[2], p[3]])
        return TF.pad(a, [0, 0, p[0], p[1], p[2], p[3]])

    return apply("zeropad2d", fn, as_tensor(x))


# ---------------------------------------------------------------------------
# pooling variants
# ---------------------------------------------------------------------------
def max_pool2d_with_index(x, kernel_size, stride=None, padding=0,
                          name=None):
    """(max, the flat H * W index of each maximum in the unpadded plane,
    int32)."""
    return _max_pool("max_pool2d_with_index", x, kernel_size, stride,
                     padding, 2, False, True)


def _unpool(name, x, indices, kernel_size, stride, padding, output_size,
            nd):
    k = _norm_tuple(kernel_size, nd)
    s = _norm_tuple(stride if stride is not None else kernel_size, nd)
    p = _norm_tuple(padding, nd)

    def fn(a, idx):
        if output_size is None:
            o = tuple((a.shape[2 + d] - 1) * s[d] - 2 * p[d] + k[d]
                      for d in range(nd))
        else:
            o = tuple(int(v) for v in list(output_size)[-nd:])
        n, c = a.shape[:2]
        total = math.prod(o)
        # an index past the output is dropped, as JAX's scatter drops it
        idx = idx.reshape(n, c, -1).long()
        idx = torch.where((idx >= 0) & (idx < total), idx, total)
        flat = torch.zeros((n, c, total + 1), dtype=a.dtype,
                           device=a.device)
        flat = flat.scatter(2, idx, a.reshape(n, c, -1))
        return flat[:, :, :total].reshape((n, c) + o)

    return apply(name, fn, as_tensor(x), as_tensor(indices))


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCL", name=None):
    """Each value written at its index, zeros elsewhere (the inverse of
    ``max_pool1d(..., return_mask=True)``)."""
    return _unpool("max_unpool1d", x, indices, kernel_size, stride, padding,
                   output_size, 1)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    return _unpool("max_unpool2d", x, indices, kernel_size, stride, padding,
                   output_size, 2)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCDHW", name=None):
    return _unpool("max_unpool3d", x, indices, kernel_size, stride, padding,
                   output_size, 3)


def _lp_pool(name, x, norm_type, kernel_size, stride, padding, ceil_mode,
             nd):
    """``(sum over the window of x ** p) ** (1 / p)`` (JAX's: the window
    sum of ``x ** p``, no absolute value; zero padding, and ``ceil_mode``'s
    extra cells, add nothing)."""
    pw = float(norm_type)
    k = _norm_tuple(kernel_size, nd)
    s = _norm_tuple(stride if stride is not None else k, nd)
    p = _norm_tuple(padding, nd)

    def fn(a):
        sp = a.shape[2:]
        pairs = [(p[d], p[d] + (_ceil_extra(sp[d], k[d], s[d], p[d])
                                if ceil_mode else 0)) for d in range(nd)]
        padded = TF.pad(a ** pw, _flat_pads(pairs))
        sums = _AVG[nd](padded, k, s) * math.prod(k)
        return sums ** (1.0 / pw)

    return apply(name, fn, as_tensor(x))


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    return _lp_pool("lp_pool1d", x, norm_type, kernel_size, stride, padding,
                    ceil_mode, 1)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _lp_pool("lp_pool2d", x, norm_type, kernel_size, stride, padding,
                    ceil_mode, 2)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_max("adaptive_max_pool3d", x, output_size, 3,
                         return_mask)


def _fractional_bounds(in_len, out_len, u, device):
    """Region starts (out_len + 1 of them) for fractional pooling (Graham
    2014): ``floor(alpha * (i + u))`` clipped, first 0, last ``in_len``."""
    alpha = in_len / out_len
    i = torch.arange(out_len + 1, dtype=torch.float32, device=device)
    b = torch.floor(alpha * (i + u)).to(torch.int64).clamp(0, in_len)
    b[0] = 0
    b[-1] = in_len
    return b


def _fractional_pool(name, x, output_size, nd, kernel_size, random_u,
                     return_mask):
    if return_mask:
        raise NotImplementedError(
            f"{name}(return_mask=True) is not supported (nor in JAX)")
    x = as_tensor(x)
    outs = _norm_tuple(output_size, nd)
    ks = _norm_tuple(kernel_size, nd) if kernel_size is not None else None
    dev = x._data.device
    if random_u is None:
        gen = framework_random.generator(dev)
        us = [torch.rand((), generator=gen, device=dev) for _ in range(nd)]
    else:
        us = [torch.as_tensor(float(random_u), dtype=torch.float32,
                              device=dev)] * nd

    def fn(a):
        for d in range(nd):
            axis = 2 + d
            n_in, n_out = a.shape[axis], outs[d]
            lo = _fractional_bounds(n_in, n_out, us[d], a.device)
            hi = torch.clamp(lo[:-1] + ks[d], max=n_in) if ks is not None \
                else lo[1:]
            lo = lo[:-1]
            pos = torch.arange(n_in, device=a.device)
            inside = (pos[None, :] >= lo[:, None]) & \
                (pos[None, :] < torch.maximum(hi, lo + 1)[:, None])
            moved = a.movedim(axis, -1).unsqueeze(-2)     # [..., 1, in]
            fill = torch.full((), -math.inf, dtype=a.dtype, device=a.device)
            a = torch.where(inside, moved, fill).amax(-1).movedim(-1, axis)
        return a

    return apply(name, fn, x)


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional_pool("fractional_max_pool2d", x, output_size, 2,
                            kernel_size, random_u, return_mask)


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional_pool("fractional_max_pool3d", x, output_size, 3,
                            kernel_size, random_u, return_mask)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def dice_loss(input, label, epsilon=1e-5, name=None):
    """``1 - (2 |X & Y| + eps) / (|X| + |Y| + eps)`` a sample, over the
    trailing class axis (label ``[..., 1]`` class ids), batch mean."""
    def fn(x, t):
        oh = (t[..., 0].long()[..., None] == torch.arange(
            x.shape[-1], device=x.device)).to(x.dtype)
        red = tuple(range(1, x.dim()))
        inter = (x * oh).sum(red)
        union = x.sum(red) + oh.sum(red)
        return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()

    return apply("dice_loss", fn, as_tensor(input), as_tensor(label))


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean", name=None):
    def fn(x, t):
        out = torch.exp(x) - t * x if log_input else \
            x - t * torch.log(x + epsilon)
        if full:
            stir = t * torch.log(t + (t == 0)) - t + 0.5 * torch.log(
                2 * math.pi * torch.clamp(t, min=1.0))
            out = out + torch.where(t > 1, stir, torch.zeros_like(stir))
        return _reduce(out, reduction)

    return apply("poisson_nll_loss", fn, as_tensor(input), as_tensor(label))


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """N-pair loss (Sohn 2016)."""
    def fn(a, p, y):
        y = y.reshape(-1).float()
        same = (y[:, None] == y[None, :]).to(a.dtype)
        same = same / same.sum(1, keepdim=True)
        ce = -(same * torch.log_softmax(a @ p.T, -1)).sum(-1)
        reg = ((a * a).sum(-1) + (p * p).sum(-1)).mean()
        return ce.mean() + l2_reg * reg * 0.25

    return apply("npair_loss", fn, as_tensor(anchor), as_tensor(positive),
                 as_tensor(labels))


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    def fn(x, t, *w):
        loss = -(t * TF.logsigmoid(x) + (1 - t) * TF.logsigmoid(-x))
        if w:
            loss = loss * w[0]
        return _reduce(loss.mean(-1), reduction)

    args = [as_tensor(input), as_tensor(label)]
    if weight is not None:
        args.append(as_tensor(weight))
    return apply("multi_label_soft_margin_loss", fn, *args)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    def fn(x, t, *w):
        n, c = x.shape
        t = t.long()
        correct = x.gather(-1, t[:, None])
        m = torch.clamp(margin - correct + x, min=0.0) ** p
        if w:
            m = m * w[0][t][:, None]
        oh = (t[:, None] == torch.arange(c, device=x.device)).to(x.dtype)
        return _reduce((m * (1 - oh)).sum(-1) / c, reduction)

    args = [as_tensor(input), as_tensor(label)]
    if weight is not None:
        args.append(as_tensor(weight))
    return apply("multi_margin_loss", fn, *args)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """``distance_function(a, b)`` takes and returns torch tensors; the
    default is ``sqrt(sum((a - b) ** 2) + 1e-12)``."""
    dist = distance_function or (
        lambda a, b: torch.sqrt(((a - b) ** 2).sum(-1) + 1e-12))

    def fn(a, p, n):
        dp, dn = dist(a, p), dist(a, n)
        if swap:
            dn = torch.minimum(dn, dist(p, n))
        return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)

    return apply("triplet_margin_with_distance_loss", fn, as_tensor(input),
                 as_tensor(positive), as_tensor(negative))


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    def fn(mu, t, var):
        var = torch.clamp(var, min=epsilon)
        out = 0.5 * (torch.log(var) + (t - mu) ** 2 / var)
        if full:
            out = out + 0.5 * math.log(2 * math.pi)
        return _reduce(out, reduction)

    return apply("gaussian_nll_loss", fn, as_tensor(input), as_tensor(label),
                 as_tensor(variance))


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over JAX's default tree: depth
    ``ceil(log2(C))``, level d's code the label's bit d, the node
    ``2 * node + 1 + code`` (capped at the last row of ``weight``)."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "custom-tree hsigmoid (path_table/path_code) is not supported; "
            "use the default complete binary tree")
    depth = max(1, int(math.ceil(math.log2(max(2, num_classes)))))

    def fn(x, t, w, *b):
        t = t.reshape(-1).long()
        node = torch.zeros_like(t)
        total = 0
        for d in range(depth):
            logits = (x * w[node]).sum(-1)
            if b:
                logits = logits + b[0][node].reshape(-1)
            c = ((t >> d) & 1).to(x.dtype)
            total = total - (c * TF.logsigmoid(logits) +
                             (1 - c) * TF.logsigmoid(-logits))
            node = torch.clamp(node * 2 + 1 + c.long(), max=w.shape[0] - 1)
        return total.mean()

    args = [as_tensor(input), as_tensor(label), as_tensor(weight)]
    if bias is not None:
        args.append(as_tensor(bias))
    return apply("hsigmoid_loss", fn, *args)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace / CosFace margins on the true class's cosine, then a
    scaled softmax cross entropy (one card's path)."""
    def fn(x, t):
        t = t.reshape(-1).long()
        theta = torch.arccos(x.gather(-1, t[:, None])[:, 0].clamp(
            -1 + 1e-7, 1 - 1e-7))
        marked = torch.cos(margin1 * theta + margin2) - margin3
        oh = (t[:, None] == torch.arange(x.shape[-1], device=x.device)).to(
            x.dtype)
        logp = torch.log_softmax((x * (1 - oh) + marked[:, None] * oh) *
                                 scale, -1)
        red = _reduce(-logp.gather(-1, t[:, None])[:, 0], reduction)
        return (red, torch.exp(logp)) if return_softmax else red

    return apply("margin_cross_entropy", fn, as_tensor(logits),
                 as_tensor(label))


# ---------------------------------------------------------------------------
# decoding helpers
# ---------------------------------------------------------------------------
def gather_tree(ids, parents):
    """Beam-search backtrace over [T, B, beam]: follow the parent
    pointers from the last step."""
    def fn(i, p):
        beams = torch.arange(i.shape[2], device=i.device).expand(
            i.shape[1:]).to(p.dtype)
        out = []
        for t in range(i.shape[0] - 1, -1, -1):
            out.append(i[t].gather(-1, beams.long()))
            beams = p[t].gather(-1, beams.long())
        return torch.stack(out[::-1])

    return apply("gather_tree", fn, as_tensor(ids), as_tensor(parents))


def rnnt_loss(logits, labels, logit_lengths, label_lengths, blank=0,
              fastemit_lambda=0.0, reduction="mean", name=None):
    """RNN-Transducer loss: the forward recursion over the (t, u) lattice
    of ``log_softmax(logits) [B, T, U + 1, V]``.  Each time step's emit
    chain ``alpha[u] = logaddexp(alpha[u], alpha[u - 1] + y[u - 1])`` is
    one prefix log-sum-exp over u (JAX runs it as a loop over u)."""
    if fastemit_lambda:
        raise NotImplementedError(
            "FastEmit regularization (fastemit_lambda != 0) is not "
            "implemented; the unregularized transducer loss would "
            "silently differ from what was requested")

    def fn(x, y, tlen, ulen):
        x = torch.log_softmax(x, -1)
        B, T, U1, V = x.shape
        U = U1 - 1
        blank_lp = x[..., blank]                              # [B, T, U+1]
        lab_lp = x[:, :, :U, :].gather(
            -1, y.long()[:, None, :, None].expand(B, T, U, 1))[..., 0]
        neg = -1e30
        first = torch.full((B, U1), neg, dtype=x.dtype, device=x.device)
        first[:, 0] = 0.0
        alphas, alpha = [], None
        zero = torch.zeros((B, 1), dtype=x.dtype, device=x.device)
        for t in range(T):
            shifted = first if t == 0 else alpha + blank_lp[:, t - 1, :]
            # c[u] = sum_{k<u} lab[t, k]: alpha[u] = c[u] +
            # logcumsumexp_j (shifted[j] - c[j])
            c = torch.cat([zero, lab_lp[:, t, :].cumsum(-1)], -1)
            alpha = c + torch.logcumsumexp(shifted - c, -1)
            alphas.append(alpha)
        alphas = torch.stack(alphas)                          # [T, B, U+1]
        t_idx, u_idx = tlen.long() - 1, ulen.long()
        batch = torch.arange(B, device=x.device)
        final = alphas[t_idx, batch, u_idx] + blank_lp[batch, t_idx, u_idx]
        return _reduce(-final, reduction)

    return apply("rnnt_loss", fn, as_tensor(logits), as_tensor(labels),
                 as_tensor(logit_lengths), as_tensor(label_lengths))


# ---------------------------------------------------------------------------
# extension ops
# ---------------------------------------------------------------------------
def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM: the first ``shift_ratio`` of the channels read from t - 1, the
    second from t + 1, the rest stay."""
    def fn(a):
        if data_format == "NHWC":
            a = a.permute(0, 3, 1, 2)
        nt, c, h, w = a.shape
        v = a.reshape(nt // seg_num, seg_num, c, h, w)
        c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
        fwd = torch.cat([torch.zeros_like(v[:, :1, :c1]), v[:, :-1, :c1]], 1)
        bwd = torch.cat([v[:, 1:, c1:c2], torch.zeros_like(v[:, :1, c1:c2])],
                        1)
        out = torch.cat([fwd, bwd, v[:, :, c2:]], 2).reshape(nt, c, h, w)
        return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out

    return apply("temporal_shift", fn, as_tensor(x))


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC's sampling: every positive class, then random negatives
    up to ``num_samples`` (all positives when they are more), the labels
    remapped into the sampled classes.  Host bookkeeping in numpy, seeded
    from the framework's generator -> (remapped labels, sampled classes)."""
    lab = np.asarray(label.numpy() if isinstance(label, Tensor)
                     else label).reshape(-1)
    dev = places.current_torch_device()
    gen = framework_random.generator(dev)
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                             device=dev).item())
    rng = np.random.RandomState(seed)
    positives = np.unique(lab)
    n_neg = max(0, num_samples - len(positives))
    negatives = np.setdiff1d(np.arange(num_classes), positives)
    if n_neg:
        negatives = rng.choice(negatives, size=min(n_neg, len(negatives)),
                               replace=False)
        sampled = np.sort(np.concatenate([positives, negatives]))
    else:
        sampled = positives
    inv = np.full(num_classes, -1, lab.dtype)
    inv[sampled] = np.arange(len(sampled), dtype=lab.dtype)
    return (wrap_array(torch.as_tensor(inv[lab], device=dev)),
            wrap_array(torch.as_tensor(sampled, device=dev)))


def _csr_allow(off, col, S):
    """CSR rows [B, H, S + 1] and columns [B, H, nnz] -> the allowed
    pairs [B, H, S, S] (entries past a row's last offset are padding)."""
    B, H, nnz = col.shape
    i = torch.arange(nnz, device=col.device).expand(B, H, nnz).contiguous()
    rows = torch.searchsorted(off[..., 1:].contiguous(), i, right=True)
    rows = torch.where(i < off[..., -1:], rows, torch.full_like(rows, S))
    allow = torch.zeros((B, H, (S + 1) * S), dtype=torch.bool,
                        device=col.device)
    allow.scatter_(2, rows * S + col.long().clamp(0, S - 1), True)
    return allow.reshape(B, H, S + 1, S)[:, :, :S]


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention over the pairs a CSR layout allows, as one dense masked
    softmax: q / k / v [B, H, S, D]."""
    has_kp, has_am = key_padding_mask is not None, attn_mask is not None

    def fn(q, k, v, off, col, *masks):
        S, D = q.shape[2], q.shape[3]
        allow = _csr_allow(off.reshape(q.shape[0], q.shape[1], -1).long(),
                           col.reshape(q.shape[0], q.shape[1], -1), S)
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(D)
        big = torch.full((), -1e30, dtype=s.dtype, device=s.device)
        s = torch.where(allow, s, big)
        if has_kp:
            s = torch.where(masks[0][:, None, None, :] > 0, s, big)
        if has_am:
            s = s + masks[-1]
        p = torch.where(allow, torch.softmax(s, -1), torch.zeros_like(s))
        return torch.einsum("bhqk,bhkd->bhqd", p, v)

    args = [as_tensor(query), as_tensor(key), as_tensor(value),
            as_tensor(sparse_csr_offset), as_tensor(sparse_csr_columns)]
    if has_kp:
        args.append(as_tensor(key_padding_mask))
    if has_am:
        args.append(as_tensor(attn_mask))
    return apply("sparse_attention", fn, *args)


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """Clustered softmax: ``tail_weights`` is a list of [proj, out] weight
    pairs -> (each row's log-prob of its label, the mean loss)."""
    shortlist = cutoffs[0]
    parts = [w for pair in tail_weights for w in pair]
    n_clusters = len(tail_weights)
    has_hb = head_bias is not None

    def fn(x, t, hw, *rest):
        head = x @ hw
        if has_hb:
            head, rest = head + rest[0], rest[1:]
        head_lp = torch.log_softmax(head, -1)
        pieces = [head_lp[..., :shortlist]]
        for c in range(n_clusters):
            tail = torch.log_softmax((x @ rest[2 * c]) @ rest[2 * c + 1], -1)
            pieces.append(tail + head_lp[..., shortlist + c][..., None])
        out = torch.cat(pieces, -1).gather(-1, t.long()[:, None])[:, 0]
        return out, -out.mean()

    args = [as_tensor(input), as_tensor(label), as_tensor(head_weight)]
    if has_hb:
        args.append(as_tensor(head_bias))
    args.extend(as_tensor(w) for w in parts)
    return apply("adaptive_log_softmax_with_loss", fn, *args)


# ---------------------------------------------------------------------------
# flash-attention entry points
# ---------------------------------------------------------------------------
def varlen_route(q, dtype=None) -> str:
    """Which attention the varlen entry points run for packed q ``[T, n,
    d]`` data, decided from the type, the head size and the device before
    anything launches.  ``dtype`` is the type the op will run in (the AMP
    hook's cast of q's; q's own when None; ``flash_attn_varlen`` and
    ``flash_attn_unpadded`` are on no AMP list, so under O1 it is the
    caller's):

    * ``"plain"``: on a CUDA tensor, inputs the kernels do not take
      (``ops.flash_attention.kernel_takes``: a type other than bf16 or a
      head_dim other than 64 / 128; JAX sends them into its kernel;
      ROADMAP.md queue 3) -- ``ops.flash_varlen.segmented_sdpa_docs``,
      the same f32 math a document at a time;
    * ``"kernel"``: ``flash_attention_segmented`` -- K2, the range kernel
      and K7a / K7b on the card, their plain versions on the CPU.
    """
    if q.device.type == "cuda" and not _fa.kernel_takes(q, dtype):
        return "plain"
    return "kernel"


def _cu(t):
    return np.asarray(as_tensor(t).numpy()).astype(np.int64)


def _packed_segments(cu, device):
    """cu_seqlens -> (total, pad rows, segment ids [1, total + pad] int32
    with -1 on the padding)."""
    from ...ops import flash_varlen as _fv
    total = int(cu[-1])
    pad = (-total) % _fv.BLOCK_ROWS if total >= _fv.BLOCK_ROWS else \
        _fv.BLOCK_ROWS - total
    seg = _fv.segment_ids_from_cu_seqlens(torch.as_tensor(cu),
                                          total).to(device)
    seg = torch.cat([seg, torch.full((pad,), -1, dtype=torch.int32,
                                     device=device)])
    return total, pad, seg[None]


def _segmented(route, q, k, v, cu, causal):
    """[T, n, d] q and [T, nkv, d] k / v packed along T (T = cu[-1])
    through the route's attention -> [T, n, d].  The kernels' route pads
    the stream to whole 128-row blocks with segment id -1 and slices the
    padding off."""
    from ...ops import flash_varlen as _fv
    if route == "plain":
        return _fv.segmented_sdpa_docs(q, k, v, cu, causal)
    total, pad, seg = _packed_segments(cu, q.device)
    if pad:
        q, k, v = (TF.pad(t, [0, 0, 0, 0, 0, pad]) for t in (q, k, v))
    return _fv.flash_attention_segmented(
        q[None].contiguous(), k[None].contiguous(), v[None].contiguous(),
        seg, causal=causal)[0, :total]


def _dense_loop(q_all, k_all, v_all, cu, cu_k, scale, causal, dropout):
    """JAX's per-sequence loop through scaled_dot_product_attention."""
    n, nkv, d = q_all.shape[1], k_all.shape[1], q_all.shape[-1]
    outs = []
    for i in range(len(cu) - 1):
        q = q_all[int(cu[i]):int(cu[i + 1])][None]
        k = k_all[int(cu_k[i]):int(cu_k[i + 1])][None]
        v = v_all[int(cu_k[i]):int(cu_k[i + 1])][None]
        if nkv != n:
            k = repeat_interleave(k, n // nkv, axis=2)
            v = repeat_interleave(v, n // nkv, axis=2)
        if scale is not None:
            q = q * (scale * math.sqrt(d))
        outs.append(scaled_dot_product_attention(
            q, k, v, is_causal=causal, dropout_p=dropout)[0])
    return concat(outs, axis=0)


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, name=None):
    """qkv [B, S, 3, H, D] through ``scaled_dot_product_attention``."""
    qkv = as_tensor(qkv)
    out = scaled_dot_product_attention(qkv[:, :, 0], qkv[:, :, 1],
                                       qkv[:, :, 2], is_causal=causal,
                                       dropout_p=dropout)
    return (out, None) if return_softmax else out


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale=None,
                                dropout=0.0, causal=False,
                                return_softmax=False, name=None):
    """Packed qkv [T, 3, H, D] over the sequences ``cu_seqlens`` bound
    (q and k share them: unequal ones raise)."""
    qkv = as_tensor(qkv)
    cu, cu_k = _cu(cu_seqlens_q), _cu(cu_seqlens_k)
    if not np.array_equal(cu, cu_k):
        raise ValueError(
            "qkv-packed varlen attention requires cu_seqlens_q == "
            "cu_seqlens_k (q/k come from the same packed tensor)")
    if dropout:
        out = _dense_loop(qkv[:, 0], qkv[:, 1], qkv[:, 2], cu, cu, scale,
                          causal, dropout)
        return (out, None) if return_softmax else out
    d = qkv.shape[-1]
    route = varlen_route(qkv._data[:, 0], amp_cast_dtype(
        "flash_attn_varlen", qkv._data.dtype))

    def fn(p):
        if scale is not None:
            p = torch.cat([p[:, :1] * (scale * math.sqrt(d)), p[:, 1:]], 1)
        return _segmented(route, p[:, 0], p[:, 1], p[:, 2], cu, causal)

    out = apply("flash_attn_varlen", fn, qkv)
    return (out, None) if return_softmax else out


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None,
                        scale=None, dropout=0.0, causal=False,
                        return_softmax=False, fixed_seed_offset=None,
                        rng_name="", training=True, name=None):
    """q [T, n, d], k / v [T, nkv, d] (nkv dividing n) over packed
    sequences; q and k share their boundaries for the one-call route."""
    query, key, value = as_tensor(query), as_tensor(key), as_tensor(value)
    cu, cu_k = _cu(cu_seqlens_q), _cu(cu_seqlens_k)
    if dropout or not np.array_equal(cu, cu_k):
        out = _dense_loop(query, key, value, cu, cu_k, scale, causal,
                          dropout)
        return (out, None) if return_softmax else out
    d = query.shape[-1]
    route = varlen_route(query._data, amp_cast_dtype(
        "flash_attn_unpadded", query._data.dtype))

    def fn(q, k, v):
        if scale is not None:
            q = q * (scale * math.sqrt(d))
        return _segmented(route, q, k, v, cu, causal)

    out = apply("flash_attn_unpadded", fn, query, key, value)
    return (out, None) if return_softmax else out


def flash_attention_with_sparse_mask(query, key, value,
                                     attn_mask_start_row_indices=None,
                                     attn_mask_start_row=0, dropout_p=0.0,
                                     is_causal=True, name=None):
    """Key j visible to queries i < ``start_row_indices[..., j]`` (and i
    >= j when causal); q / k / v [B, S, H, D]."""
    if attn_mask_start_row_indices is None:
        return scaled_dot_product_attention(query, key, value,
                                            is_causal=is_causal,
                                            dropout_p=dropout_p)

    def fn(q, k, v, st):
        S, D = q.shape[1], q.shape[3]
        if st.dim() == 4:
            st = st[:, :, 0, :]
        pos = torch.arange(S, device=q.device)
        allow = pos[None, None, :, None] < st[:, :, None, :]
        if is_causal:
            allow = allow & (pos[:, None] >= pos[None, :])
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
        s = torch.where(allow, s, torch.full((), -1e30, dtype=s.dtype,
                                             device=s.device))
        p = torch.softmax(s, -1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)

    return apply("flash_attention_with_sparse_mask", fn, as_tensor(query),
                 as_tensor(key), as_tensor(value),
                 as_tensor(attn_mask_start_row_indices))
