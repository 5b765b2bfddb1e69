"""Grouped-query attention in plain PyTorch.

Counterpart of ``paddle_tpu/models/decode.py``'s ``_grouped_attn``.  In the
port it is the one plain attention every kernel's plain version reduces to:
the paged decode attention over gathered pages and the segmented prefill
attention over a packed stream (ops/).
"""

from __future__ import annotations

import math

import torch

__all__ = ["_grouped_attn"]


def _grouped_attn(q, ck, cv, mask):
    """q [b, sq, n, d] against a [b, S, nkv, d] cache (GQA broadcast inside
    the einsum); ``mask`` (bool) must broadcast to [b, nkv, g, sq, S]."""
    b, sq, n, d = q.shape
    nkv = ck.shape[2]
    g = n // nkv
    scale = 1.0 / math.sqrt(d)
    q5 = q.reshape(b, sq, nkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q5, ck) * scale
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits.float(), -1).to(cv.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, cv)
    return out.reshape(b, sq, n, d)
