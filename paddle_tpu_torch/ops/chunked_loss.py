"""Chunked softmax cross-entropy: the LM loss head without the [B, S, V]
f32 logits.

Counterpart of ``paddle_tpu/ops/chunked_loss.py`` (no Pallas kernel there;
the matrix products stay with the library here as they stay with XLA there).
A ``torch.autograd.Function`` whose forward walks the flattened tokens in
chunks, forms each chunk's logits (operands in the compute type, f32
accumulation and output), reduces them at once to (log-sum-exp, target
logit) and drops them; the backward walks the chunks again, forms
``softmax - onehot`` per chunk and accumulates dx and, in f32, dW.  Only
``x``, ``w`` and ``targets`` are saved.
"""

from __future__ import annotations

import torch

__all__ = ["chunked_softmax_cross_entropy"]


def _mm_f32(a, b):
    """``a @ b`` with f32 accumulation and an f32 result, for operands in
    f32 or a 16-bit type (the product the JAX code asks for with
    ``preferred_element_type=float32``)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _flatten(x, targets, num_chunks):
    H = x.shape[-1]
    xf = x.reshape(-1, H)
    tf = targets.reshape(-1)
    T = xf.shape[0]
    if T % num_chunks:
        raise ValueError(
            f"token count {T} not divisible by loss chunk count {num_chunks}")
    C = T // num_chunks
    return xf.reshape(num_chunks, C, H), tf.reshape(num_chunks, C), T


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets, num_chunks, dt):
        xs, ts, T = _flatten(x, targets, num_chunks)
        wc = w.to(dt)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for xc, tc in zip(xs, ts):
            logits = _mm_f32(xc.to(dt), wc)                      # [C, V] f32
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(-1, tc[:, None])[:, 0]
            total = total + (lse - tgt).sum()
        ctx.save_for_backward(x, w, targets)
        ctx.num_chunks, ctx.dt = num_chunks, dt
        return total / T

    @staticmethod
    def backward(ctx, g):
        x, w, targets = ctx.saved_tensors
        dt = ctx.dt
        xs, ts, T = _flatten(x, targets, ctx.num_chunks)
        wc = w.to(dt)
        scale = (g / T).float()
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dxs = []
        for xc, tc in zip(xs, ts):
            xc = xc.to(dt)
            d_logits = torch.softmax(_mm_f32(xc, wc), dim=-1)    # [C, V] f32
            d_logits.scatter_add_(
                -1, tc[:, None],
                torch.full((tc.shape[0], 1), -1.0, dtype=torch.float32,
                           device=x.device))
            d_logits_c = (d_logits * scale).to(dt)
            dxs.append(_mm_f32(d_logits_c, wc.t()))              # [C, H]
            dw += _mm_f32(xc.t(), d_logits_c)                    # [H, V]
        dx = torch.cat(dxs).reshape(x.shape)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def chunked_softmax_cross_entropy(x, w, targets, num_chunks: int = 8,
                                  compute_dtype=torch.bfloat16):
    """Mean NLL of ``softmax(x @ w)`` at ``targets`` without materialising
    the full logits tensor.

    x: [..., H] activations (any float dtype), w: [H, V] unembedding,
    targets: [...] int labels; the leading dims are flattened and must be
    divisible by ``num_chunks`` (``ValueError`` otherwise)."""
    return _ChunkedCE.apply(x, w, targets, num_chunks, compute_dtype)
