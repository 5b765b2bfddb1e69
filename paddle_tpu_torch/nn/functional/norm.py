"""``instance_norm``, ``group_norm``, ``local_response_norm`` and
``normalize`` (counterpart of those functions of
``paddle_tpu/nn/functional/__init__.py``).

JAX's rules, kept here: ``instance_norm`` normalises each sample's channel
over its spatial axes with the biased variance and reads neither running
statistic (``use_input_stats`` and ``momentum`` are taken and not read);
``group_norm`` takes channel-first input whatever ``data_format`` says;
``local_response_norm`` divides by ``(k + alpha * sum) ** beta`` with the
window's plain sum of squares (torch's divides alpha by the window size,
so it is written out here); ``normalize`` divides by ``max(||x||_p,
epsilon)``.  JAX has no Pallas kernel for any of them: torch's
``instance_norm`` and ``group_norm`` (the same math in one pass) and torch
ops on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...ops.dispatch import apply, as_tensor

__all__ = ["instance_norm", "group_norm", "local_response_norm",
           "normalize"]


def _affine_args(x, weight, bias):
    args = [as_tensor(x)]
    if weight is not None:
        args.append(as_tensor(weight))
    if bias is not None:
        args.append(as_tensor(bias))
    return args


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9,
                  eps=1e-5, data_format="NCHW", name=None):
    has_w, has_b = weight is not None, bias is not None

    def fn(a, *wb):
        w = wb[0] if has_w else None
        b = wb[-1] if has_b else None
        return TF.instance_norm(a, None, None, w, b, True, 0.0, eps)

    return apply("instance_norm", fn, *_affine_args(x, weight, bias))


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    has_w, has_b = weight is not None, bias is not None

    def fn(a, *wb):
        w = wb[0] if has_w else None
        b = wb[-1] if has_b else None
        return TF.group_norm(a, num_groups, w, b, epsilon)

    return apply("group_norm", fn, *_affine_args(x, weight, bias))


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    def fn(a):
        sq = a * a
        half = size // 2
        # the channel axis last, zero-padded (half, size - half - 1)
        padded = TF.pad(sq.movedim(1, -1), [half, size - half - 1])
        c = a.shape[1]
        summed = sum(padded[..., i:i + c] for i in range(size))
        return a / torch.pow(k + alpha * summed.movedim(-1, 1), beta)

    return apply("local_response_norm", fn, as_tensor(x))


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def fn(a):
        nrm = (a.abs() ** p).sum(axis, keepdim=True) ** (1.0 / p)
        return a / torch.clamp(nrm, min=epsilon)

    return apply("normalize", fn, as_tensor(x))
