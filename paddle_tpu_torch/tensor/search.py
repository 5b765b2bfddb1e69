"""``argmax``, ``topk`` and ``top_p_sampling``.

Counterpart of the same functions of ``paddle_tpu/tensor/search.py``.
``top_p_sampling`` draws from the framework's generator of the logits'
device (or one seeded with ``seed``): it matches JAX's in distribution,
not bit for bit.
"""

from __future__ import annotations

import torch

from ..framework import dtype as dtypes
from ..framework import random as framework_random
from ..ops.dispatch import apply, as_tensor
from .tensor import Tensor

__all__ = ["argmax", "topk", "top_p_sampling"]


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    """The first maximal index (along ``axis``, or of the flattened
    tensor)."""
    tdt = dtypes.to_torch_dtype(dtype)
    if axis is None:
        return apply("argmax", lambda a: torch.argmax(a.reshape(-1)).to(tdt),
                     as_tensor(x))
    return apply("argmax", lambda a: torch.argmax(
        a, dim=int(axis), keepdim=keepdim).to(tdt), as_tensor(x))


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """(values, int64 indices) of the ``k`` largest (or smallest) along
    ``axis`` (the last by default)."""
    k = int(k.item()) if isinstance(k, Tensor) else int(k)
    ax = -1 if axis is None else int(axis)

    def fn(a):
        vals, idx = torch.topk(a, k, dim=ax, largest=largest, sorted=True)
        return vals, idx.to(torch.int64)

    return apply("topk", fn, as_tensor(x))


def top_p_sampling(x, ps, threshold=None, seed=None, name=None):
    """Nucleus sampling over the last axis of logits ``x`` with the
    per-row mass ``ps``: (the kept probability of each pick, its int64
    index), each ``[..., 1]``."""
    x, ps = as_tensor(x), as_tensor(ps)
    dev = x._data.device
    gen = framework_random.generator(dev) if seed is None else \
        torch.Generator(device=dev).manual_seed(int(seed))

    def fn(logits, p):
        probs = torch.softmax(logits, dim=-1)
        sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True,
                                              stable=True)
        cum = torch.cumsum(sorted_probs, dim=-1)
        keep = cum - sorted_probs <= p[..., None].to(cum.dtype)
        filt = torch.where(keep, sorted_probs, torch.zeros_like(sorted_probs))
        filt = filt / filt.sum(-1, keepdim=True)
        flat = filt.reshape(-1, filt.shape[-1]).float()
        choice = torch.multinomial(flat, 1, generator=gen).reshape(
            filt.shape[:-1] + (1,))
        ids = torch.gather(sorted_idx, -1, choice)
        return torch.gather(filt, -1, choice), ids.to(torch.int64)

    return apply("top_p_sampling", fn, x, ps)
