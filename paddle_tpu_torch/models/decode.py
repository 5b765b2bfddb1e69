"""The dense-cache decode: greedy / sampled generation and beam search over
a preallocated KV cache, grouped-query attention in plain PyTorch, and
weight-only int8 quantization of a checkpoint.

Counterpart of ``paddle_tpu/models/decode.py``.  :func:`make_generate` and
:func:`make_generate_beam` return functions that run JAX's single program
eagerly: a causal prefill over the prompt that collects each layer's K / V
(RoPE through ``_rope``, so the fused RoPE kernel at ``head_dim % 128 ==
0``), a cache ``[L, B, max_len, nkv, d]`` in ``cfg.dtype`` written in
place, then one step a token that rotates q / k at the token's absolute
position and attends to the cache up to it.  Beam search keeps ``B * K``
cache rows and reorders them by ancestry after each step.  The block math
is ``llama_pretrain``'s (``_rms_norm``, ``_mm``, ``_rope``,
``_block_post_attn``), so int8 weights from :func:`quantize_params_int8`
go through the int8 matmul kernel.  Sampling draws from a
``torch.Generator``: equal to JAX's ``jax.random`` draws in distribution,
not bit for bit.

``_grouped_attn`` is the one plain attention every attention kernel's plain
version reduces to: the paged decode attention over gathered pages and the
segmented prefill attention over a packed stream (ops/).
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Optional

import torch

from ..ops.int8_matmul import quantize_int8

if TYPE_CHECKING:
    from .llama_pretrain import LlamaPretrainConfig

# llama_pretrain imports ops.flash_varlen, which imports _grouped_attn from
# here: the generation functions import the block math when they run

__all__ = ["_grouped_attn", "quantize_params_int8", "make_generate",
           "make_generate_beam"]


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


def _rope_single(x, theta, pos: int):
    """Rotate-half RoPE of x [b, 1, n, d] at the one position ``pos``."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    freqs = float(pos) * inv
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * cos - x2f * sin,
                      x2f * cos + x1f * sin], -1).to(x.dtype)


def _pre_attn_at(bp, x, cfg: LlamaPretrainConfig, pos: int):
    """ln1, the q / k / v products and RoPE for one decode position; K / V
    stay at ``num_key_value_heads`` (the GQA broadcast is inside the
    attention, never in the cache)."""
    from .llama_pretrain import _mm, _rms_norm
    b = x.shape[0]
    n, d, nkv = cfg.num_attention_heads, cfg.head_dim, \
        cfg.num_key_value_heads
    dt = cfg.dtype
    y = _rms_norm(x, bp["ln1"], cfg.rms_norm_eps)
    q = _mm(y, bp["wq"], dt).reshape(b, 1, n, d)
    k = _mm(y, bp["wk"], dt).reshape(b, 1, nkv, d)
    v = _mm(y, bp["wv"], dt).reshape(b, 1, nkv, d)
    return (_rope_single(q, cfg.rope_theta, pos),
            _rope_single(k, cfg.rope_theta, pos), v)


def _cached_attn(q, ck, cv, pos: int):
    """q [b, 1, n, d] against the cache [b, S, nkv, d], up to ``pos``."""
    S = ck.shape[1]
    mask = (torch.arange(S, device=q.device) <= pos)[None, None, None,
                                                       None, :]
    return _grouped_attn(q, ck, cv, mask)


def _check_len(prompt_len, max_new_tokens, max_len):
    S_max = max_len or (prompt_len + max_new_tokens)
    if S_max < prompt_len + max_new_tokens:
        raise ValueError("max_len too small for prompt + new tokens")
    return S_max


def _prefill(cfg: LlamaPretrainConfig, params, prompt):
    """The causal forward over ``prompt [B, P]`` -> (hidden [B, P, h],
    K and V ``[L, B, P, nkv, d]``)."""
    from .llama_pretrain import (_block_post_attn, _mm, _rms_norm, _rope,
                                 layer_params)
    B, P = prompt.shape
    n, d, nkv = cfg.num_attention_heads, cfg.head_dim, \
        cfg.num_key_value_heads
    dt = cfg.dtype
    causal = torch.tril(torch.ones((P, P), dtype=torch.bool,
                                   device=prompt.device))
    x = params["embed"][prompt].to(dt)
    ks, vs = [], []
    for layer in range(cfg.num_hidden_layers):
        bp = layer_params(params, layer)
        y = _rms_norm(x, bp["ln1"], cfg.rms_norm_eps)
        q = _mm(y, bp["wq"], dt).reshape(B, P, n, d)
        k = _mm(y, bp["wk"], dt).reshape(B, P, nkv, d)
        v = _mm(y, bp["wv"], dt).reshape(B, P, nkv, d)
        q, k = _rope(q, k, cfg.rope_theta)
        attn = _grouped_attn(q, k, v, causal[None, None, None])
        x = _block_post_attn(bp, x, attn, cfg)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def _decode_token(cfg: LlamaPretrainConfig, params, tok, cache_k, cache_v,
                  pos: int):
    """One token a row at position ``pos``: writes its K / V into the cache
    rows (in place) -> the last hidden state [rows, 1, h]."""
    from .llama_pretrain import _block_post_attn, layer_params
    dt = cfg.dtype
    xt = params["embed"][tok][:, None].to(dt)
    for layer in range(cfg.num_hidden_layers):
        bp = layer_params(params, layer)
        q, k, v = _pre_attn_at(bp, xt, cfg, pos)
        cache_k[layer, :, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[layer, :, pos] = v[:, 0].to(cache_v.dtype)
        attn = _cached_attn(q, cache_k[layer], cache_v[layer], pos)
        xt = _block_post_attn(bp, xt, attn, cfg)
    return xt


def _generator(key, device):
    """``key``: a ``torch.Generator``, or an int seed (None: 0)."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(
        0 if key is None else int(key))


def make_generate(cfg: LlamaPretrainConfig, prompt_len: int,
                  max_new_tokens: int, max_len: Optional[int] = None,
                  temperature: float = 0.0):
    """``generate(params, prompt [B, prompt_len], key=None) -> tokens [B,
    max_new_tokens]`` (int64, on the params' device).  ``temperature ==
    0`` is greedy (the first maximal logit); otherwise categorical sampling
    at that temperature from ``key`` (a ``torch.Generator`` or an int
    seed).  ``max_len`` (default prompt + new) sizes the cache and must
    hold both."""
    from .llama_pretrain import _mm, _rms_norm
    S_max = _check_len(prompt_len, max_new_tokens, max_len)

    def head_logits(params, x_last):
        h = _rms_norm(x_last, params["final_norm"], cfg.rms_norm_eps)
        return _mm(h, params["lm_head"], cfg.dtype).float()

    def pick(logits, gen):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    @torch.no_grad()
    def generate(params, prompt, key=None):
        dev = params["embed"].device
        prompt = torch.as_tensor(prompt, device=dev).long()
        if prompt.shape[1] != prompt_len:
            raise ValueError(f"prompt length {prompt.shape[1]} != "
                             f"prompt_len {prompt_len}")
        gen = _generator(key, dev)
        B = prompt.shape[0]
        x, ks, vs = _prefill(cfg, params, prompt)
        L, nkv, d = ks.shape[0], cfg.num_key_value_heads, cfg.head_dim
        cache_k = torch.zeros((L, B, S_max, nkv, d), dtype=cfg.dtype,
                              device=dev)
        cache_v = torch.zeros_like(cache_k)
        cache_k[:, :, :prompt_len] = ks.to(cfg.dtype)
        cache_v[:, :, :prompt_len] = vs.to(cfg.dtype)
        del ks, vs
        tok = pick(head_logits(params, x[:, -1]), gen)
        out = [tok]
        for t in range(max_new_tokens - 1):
            xt = _decode_token(cfg, params, tok, cache_k, cache_v,
                               prompt_len + t)
            tok = pick(head_logits(params, xt[:, 0]), gen)
            out.append(tok)
        return torch.stack(out, dim=1)

    return generate


def make_generate_beam(cfg: LlamaPretrainConfig, prompt_len: int,
                       max_new_tokens: int, num_beams: int,
                       max_len: Optional[int] = None,
                       length_penalty: float = 1.0):
    """``generate(params, prompt [B, prompt_len]) -> (tokens [B,
    max_new_tokens], scores [B])``: beam search with ``num_beams`` beams a
    prompt.  The prefill runs once and its cache is repeated to ``B * K``
    rows; each step expands K x V continuations, keeps the global top K
    by summed log-probability and gathers the cache rows (this step's K /
    V included) and the token history by beam ancestry.  No eos: every
    beam runs ``max_new_tokens``, so ``length_penalty`` divides all
    scores alike.  ``num_beams == 1`` is greedy."""
    from .llama_pretrain import _mm, _rms_norm
    S_max = _check_len(prompt_len, max_new_tokens, max_len)
    K = num_beams
    if K < 1:
        raise ValueError("num_beams must be >= 1")

    def head_logp(params, x_last):
        h = _rms_norm(x_last, params["final_norm"], cfg.rms_norm_eps)
        return torch.log_softmax(_mm(h, params["lm_head"],
                                     cfg.dtype).float(), dim=-1)

    @torch.no_grad()
    def generate(params, prompt):
        dev = params["embed"].device
        prompt = torch.as_tensor(prompt, device=dev).long()
        B = prompt.shape[0]
        x, ks, vs = _prefill(cfg, params, prompt)
        L, nkv, d = ks.shape[0], cfg.num_key_value_heads, cfg.head_dim
        cache_k = torch.zeros((L, B * K, S_max, nkv, d), dtype=cfg.dtype,
                              device=dev)
        cache_v = torch.zeros_like(cache_k)
        cache_k[:, :, :prompt_len] = ks.to(cfg.dtype).repeat_interleave(
            K, dim=1)
        cache_v[:, :, :prompt_len] = vs.to(cfg.dtype).repeat_interleave(
            K, dim=1)
        del ks, vs
        scores, tok = torch.topk(head_logp(params, x[:, -1]), K)  # [B, K]
        toks = torch.zeros((B, K, max_new_tokens), dtype=torch.int64,
                           device=dev)
        toks[:, :, 0] = tok
        rows = torch.arange(B, device=dev)
        for t in range(max_new_tokens - 1):
            xt = _decode_token(cfg, params, tok.reshape(B * K), cache_k,
                               cache_v, prompt_len + t)
            logp = head_logp(params, xt[:, 0])
            V = logp.shape[-1]
            total = scores[:, :, None] + logp.reshape(B, K, V)
            scores, idx = torch.topk(total.reshape(B, K * V), K)
            beam_src = idx // V
            tok = idx % V
            flat_src = (rows[:, None] * K + beam_src).reshape(-1)
            cache_k = cache_k[:, flat_src]
            cache_v = cache_v[:, flat_src]
            toks = torch.gather(toks, 1, beam_src[:, :, None].expand(
                -1, -1, max_new_tokens)).clone()
            toks[:, :, t + 1] = tok
        norm = scores / (float(max_new_tokens) ** length_penalty)
        best = torch.argmax(norm, dim=1)
        return toks[rows, best], scores[rows, best]

    return generate
