"""nn.functional's losses beyond ``cross_entropy`` (counterpart of the loss
block of ``paddle_tpu/nn/functional/__init__.py``):
``softmax_with_cross_entropy``, ``binary_cross_entropy`` (probabilities
clipped to [1e-12, 1 - 1e-12]) and ``binary_cross_entropy_with_logits``,
``mse_loss``, ``square_error_cost``, ``l1_loss``, ``smooth_l1_loss``
(Paddle's, times ``delta``), ``nll_loss``, ``kl_div`` (``batchmean``
divides by the batch), ``margin_ranking_loss``, ``hinge_embedding_loss``,
``cosine_embedding_loss``, ``soft_margin_loss``, ``triplet_margin_loss``,
``sigmoid_focal_loss``, ``log_loss`` and ``ctc_loss``.

Each is one op under JAX's name over torch ops (JAX has no Pallas kernel
for a loss).  ``ctc_loss`` takes ``log_probs [T, B, C]`` through a log
softmax (as ``optax.ctc_loss`` does with its logits) into torch's CTC (the
native CUDA kernel on the card), reduced as JAX reduces: ``mean`` is the
batch mean of the sequences' losses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...ops.dispatch import apply, as_tensor
from ...tensor.manipulation import unsqueeze
from . import cross_entropy, softmax

__all__ = ["softmax_with_cross_entropy", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "mse_loss",
           "square_error_cost", "l1_loss", "smooth_l1_loss", "nll_loss",
           "kl_div", "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "soft_margin_loss",
           "triplet_margin_loss", "sigmoid_focal_loss", "log_loss",
           "ctc_loss"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _opt(*ts):
    return [as_tensor(t) for t in ts if t is not None]


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = unsqueeze(loss, axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    def fn(p, y, *w):
        p = p.clamp(1e-12, 1.0 - 1e-12)
        loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
        return _reduce(loss * w[0] if w else loss, reduction)

    return apply("binary_cross_entropy", fn, *_opt(input, label, weight))


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    has_w = weight is not None

    def fn(z, y, *rest):
        w = rest[0] if has_w else None
        pw = rest[-1] if pos_weight is not None else None
        ls, lms = TF.logsigmoid(z), TF.logsigmoid(-z)
        pos = y * ls if pw is None else pw * y * ls
        loss = -(pos + (1 - y) * lms)
        return _reduce(loss if w is None else loss * w, reduction)

    return apply("bce_with_logits", fn,
                 *_opt(logit, label, weight, pos_weight))


def mse_loss(input, label, reduction="mean", name=None):
    return apply("mse_loss", lambda a, b: _reduce((a - b) ** 2, reduction),
                 as_tensor(input), as_tensor(label))


def square_error_cost(input, label):
    return apply("square_error_cost", lambda a, b: (a - b) ** 2,
                 as_tensor(input), as_tensor(label))


def l1_loss(input, label, reduction="mean", name=None):
    return apply("l1_loss", lambda a, b: _reduce((a - b).abs(), reduction),
                 as_tensor(input), as_tensor(label))


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    def fn(a, b):
        d = a - b
        loss = torch.where(d.abs() < delta, 0.5 * d * d / delta,
                           d.abs() - 0.5 * delta)
        return _reduce(loss * delta, reduction)

    return apply("smooth_l1_loss", fn, as_tensor(input), as_tensor(label))


def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean", name=None):
    """``-logp[n, y[n], ...]``; ``ignore_index`` rows count nowhere; a
    weighted mean divides by the kept rows' weights."""
    def fn(logp, y, *w):
        y = y.long()
        mask = y != ignore_index
        safe = torch.where(mask, y, torch.zeros_like(y))
        loss = -logp.gather(1, safe.unsqueeze(1)).squeeze(1)
        loss = torch.where(mask, loss, torch.zeros_like(loss))
        if w:
            wt = w[0][safe]
            loss = loss * wt
            if reduction == "mean":
                return loss.sum() / (wt * mask).sum()
        if reduction == "mean":
            return loss.sum() / torch.clamp(mask.sum(), min=1)
        return _reduce(loss, reduction)

    return apply("nll_loss", fn, *_opt(input, label, weight))


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    def fn(lp, t):
        if log_target:
            loss = torch.exp(t) * (t - lp)
        else:
            loss = t * (torch.log(torch.clamp(t, min=1e-30)) - lp)
        if reduction == "batchmean":
            return loss.sum() / lp.shape[0]
        return _reduce(loss, reduction)

    return apply("kl_div", fn, as_tensor(input), as_tensor(label))


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return apply("margin_ranking_loss",
                 lambda a, b, y: _reduce(torch.clamp(-y * (a - b) + margin,
                                                     min=0.0), reduction),
                 as_tensor(input), as_tensor(other), as_tensor(label))


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    def fn(a, y):
        return _reduce(torch.where(y == 1, a, torch.clamp(margin - a,
                                                          min=0.0)),
                       reduction)

    return apply("hinge_embedding_loss", fn, as_tensor(input),
                 as_tensor(label))


def _cos(a, b, eps):
    den = torch.linalg.vector_norm(a, dim=-1) * \
        torch.linalg.vector_norm(b, dim=-1)
    return (a * b).sum(-1) / torch.clamp(den, min=eps)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    def fn(a, b, y):
        cos = _cos(a, b, 1e-12)
        return _reduce(torch.where(y == 1, 1 - cos,
                                   torch.clamp(cos - margin, min=0.0)),
                       reduction)

    return apply("cosine_embedding_loss", fn, as_tensor(input1),
                 as_tensor(input2), as_tensor(label))


def soft_margin_loss(input, label, reduction="mean", name=None):
    return apply("soft_margin_loss",
                 lambda a, y: _reduce(torch.log1p(torch.exp(-y * a)),
                                      reduction),
                 as_tensor(input), as_tensor(label))


def _pdist(a, b, p):
    return ((a - b).abs() ** p).sum(-1) ** (1 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def fn(a, pos, neg):
        dp, dn = _pdist(a, pos, p), _pdist(a, neg, p)
        if swap:
            dn = torch.minimum(dn, _pdist(pos, neg, p))
        return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)

    return apply("triplet_margin_loss", fn, as_tensor(input),
                 as_tensor(positive), as_tensor(negative))


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum", name=None):
    def fn(z, y, *n):
        p = torch.sigmoid(z)
        ce = -(y * TF.logsigmoid(z) + (1 - y) * TF.logsigmoid(-z))
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        loss = a_t * ((1 - p_t) ** gamma) * ce
        return _reduce(loss / n[0] if n else loss, reduction)

    return apply("sigmoid_focal_loss", fn, *_opt(logit, label, normalizer))


def log_loss(input, label, epsilon=1e-4, name=None):
    return apply("log_loss",
                 lambda p, y: -y * torch.log(p + epsilon) - (1 - y) *
                 torch.log(1 - p + epsilon),
                 as_tensor(input), as_tensor(label))


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    def fn(lp, lab, il, ll):
        lsm = torch.log_softmax(lp.float(), -1)
        loss = TF.ctc_loss(lsm, lab.long(), il.long(), ll.long(),
                           blank=blank, reduction="none")
        return _reduce(loss.to(lp.dtype), reduction)

    return apply("ctc_loss", fn, as_tensor(log_probs), as_tensor(labels),
                 as_tensor(input_lengths), as_tensor(label_lengths))
