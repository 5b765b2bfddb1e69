"""Grouped-query attention in plain PyTorch, and weight-only int8
quantization of a checkpoint.

Counterpart of ``paddle_tpu/models/decode.py``'s ``_grouped_attn`` and
``quantize_params_int8``.  ``_grouped_attn`` is the one plain attention
every attention kernel's plain version reduces to: the paged decode
attention over gathered pages and the segmented prefill attention over a
packed stream (ops/).
"""

from __future__ import annotations

import math

import torch

from ..ops.int8_matmul import quantize_int8

__all__ = ["_grouped_attn", "quantize_params_int8"]


def quantize_params_int8(params):
    """Weight-only int8 quantization of a LLaMA param dict for serving:
    every block matrix (each layer of the stacked ``[L, K, N]`` tensor on
    its own, as JAX's ``jax.vmap(quantize_int8)``) and ``lm_head`` become
    ``{"q": int8, "s": f32}`` with per-output-channel scales; the norms
    and ``embed`` stay as they are.  ``_mm`` sends such a dict to the
    int8 matmul kernel."""

    def stacked(w):
        # layer by layer, so that the f32 temporaries stay one layer big
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty((w.shape[0], w.shape[-1]), dtype=torch.float32,
                        device=w.device)
        for layer in range(w.shape[0]):
            qd = quantize_int8(w[layer])
            q[layer], s[layer] = qd["q"], qd["s"]
        return {"q": q, "s": s}

    out = dict(params)
    out["blocks"] = {name: w if name.startswith("ln") else stacked(w)
                     for name, w in params["blocks"].items()}
    out["lm_head"] = quantize_int8(params["lm_head"])
    return out


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
