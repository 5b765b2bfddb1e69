"""LLaMA as Paddle Layers: the user API's LLM.

Counterpart of ``paddle_tpu/models/llama.py``.  On the card its default
path reaches the port's kernels through the API: every ``RMSNorm`` runs
K9a (K9b in the backward), a full-sequence attention runs K6a (K6b / K6c
in the backward) by ``F.sdpa_route``, the rotary embedding of a forward
without a cache offset runs K5, ``swiglu`` runs K10a / K10b under
``FLAGS_pallas_swiglu``, and ``generate_compiled(quantize_int8=True)``
runs K3.

``generate`` is JAX's eager loop over a concatenated KV cache (the cache
grows by one token a step, re-copied each time).  ``generate_compiled``
maps the parameters onto ``llama_pretrain``'s stacked tree
(``_pretrain_params``, kept until a parameter changes) and runs the dense
decode of ``models/decode.py`` in f32, as JAX pins it; ``generate_auto``
(models/paged_decode.py) serves the same tree.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..nn import Embedding, Layer, LayerList, Linear, RMSNorm
from ..nn import functional as F
from ..incubate.nn.functional import fused_rotary_position_embedding, swiglu
from ..tensor.linalg import matmul
from ..tensor.manipulation import concat, repeat_interleave, reshape
from ..tensor.search import argmax, top_p_sampling
from ..tensor.tensor import Tensor, wrap_array

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaDecoderLayer", "LlamaAttention", "LlamaMLP"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    tensor_parallel: bool = True

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def _make_linear(cfg, in_f, out_f, kind):
    from ._layers import make_tp_linear
    return make_tp_linear(cfg.tensor_parallel, in_f, out_f, kind,
                          has_bias=False)


class LlamaAttention(Layer):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        kvh = cfg.num_key_value_heads * cfg.head_dim
        self.q_proj = _make_linear(cfg, h, h, "col")
        self.k_proj = _make_linear(cfg, h, kvh, "col")
        self.v_proj = _make_linear(cfg, h, kvh, "col")
        self.o_proj = _make_linear(cfg, h, h, "row")

    def forward(self, x, cache=None):
        cfg = self.cfg
        b, s, h = x.shape
        n, nkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, \
            cfg.head_dim
        q = reshape(self.q_proj(x), [b, s, n, d])
        k = reshape(self.k_proj(x), [b, s, nkv, d])
        v = reshape(self.v_proj(x), [b, s, nkv, d])
        if cache is not None and cache[0].shape[1] > 0:
            # decode with a cache: the new tokens sit at absolute positions
            # cache_len .. cache_len + s - 1
            offset = cache[0].shape[1]
            q, k, _ = fused_rotary_position_embedding(
                q, k, position_ids=np.arange(offset, offset + s),
                rotary_emb_base=cfg.rope_theta)
        else:
            q, k, _ = fused_rotary_position_embedding(
                q, k, rotary_emb_base=cfg.rope_theta)
        if cache is not None:
            k = concat([cache[0], k], axis=1)
            v = concat([cache[1], v], axis=1)
            new_cache = (k, v)
        if nkv != n:
            k = repeat_interleave(k, n // nkv, axis=2)
            v = repeat_interleave(v, n // nkv, axis=2)
        # causal about the query span: a prefill is causal, one decode
        # token attends to everything cached
        out = F.scaled_dot_product_attention(q, k, v, is_causal=(s > 1))
        out = self.o_proj(reshape(out, [b, s, h]))
        if cache is not None:
            return out, new_cache
        return out


class LlamaMLP(Layer):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _make_linear(cfg, h, f, "col")
        self.up_proj = _make_linear(cfg, h, f, "col")
        self.down_proj = _make_linear(cfg, f, h, "row")

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(Layer):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size,
                                       epsilon=cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                epsilon=cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, cache=None):
        y = self.input_layernorm(x)
        if cache is not None:
            attn, new_cache = self.self_attn(y, cache)
        else:
            attn = self.self_attn(y)
        x = x + attn
        x = x + self.mlp(self.post_attention_layernorm(x))
        if cache is not None:
            return x, new_cache
        return x


class LlamaModel(Layer):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = LayerList(
            [LlamaDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_norm_eps)

    def forward(self, input_ids, caches=None):
        x = self.embed_tokens(input_ids)
        new_caches = []
        for i, layer in enumerate(self.layers):
            if caches is not None:
                x, c = layer(x, caches[i])
                new_caches.append(c)
            else:
                x = layer(x)
        x = self.norm(x)
        if caches is not None:
            return x, new_caches
        return x


_NAMES = {"ln1": lambda l: l.input_layernorm.weight,
          "wq": lambda l: l.self_attn.q_proj.weight,
          "wk": lambda l: l.self_attn.k_proj.weight,
          "wv": lambda l: l.self_attn.v_proj.weight,
          "wo": lambda l: l.self_attn.o_proj.weight,
          "ln2": lambda l: l.post_attention_layernorm.weight,
          "w_gate": lambda l: l.mlp.gate_proj.weight,
          "w_up": lambda l: l.mlp.up_proj.weight,
          "w_down": lambda l: l.mlp.down_proj.weight}


class LlamaForCausalLM(Layer):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.llama = LlamaModel(cfg)
        self.lm_head = None if cfg.tie_word_embeddings else \
            Linear(cfg.hidden_size, cfg.vocab_size, bias_attr=False)

    def forward(self, input_ids, labels=None, caches=None):
        if caches is not None:
            x, new_caches = self.llama(input_ids, caches)
        else:
            x = self.llama(input_ids)
        if self.lm_head is None:
            logits = matmul(x, self.llama.embed_tokens.weight,
                            transpose_y=True)
        else:
            logits = self.lm_head(x)
        if labels is not None:
            return F.cross_entropy(reshape(logits, [-1, self.cfg.vocab_size]),
                                   reshape(labels, [-1]))
        if caches is not None:
            return logits, new_caches
        return logits

    def _pretrain_params(self):
        """This model's parameters as ``llama_pretrain``'s tree: the blocks
        stacked ``[L, ...]`` (a copy, as JAX's ``jnp.stack``), the
        embedding, the final norm and the head (the embedding's transpose
        when tied)."""
        layers = list(self.llama.layers)
        with torch.no_grad():
            blocks = {k: torch.stack([get(layer)._data.detach()
                                      for layer in layers])
                      for k, get in _NAMES.items()}
        embed = self.llama.embed_tokens.weight._data.detach()
        lm_head = embed.t() if self.lm_head is None else \
            self.lm_head.weight._data.detach()
        return {"embed": embed, "blocks": blocks,
                "final_norm": self.llama.norm.weight._data.detach(),
                "lm_head": lm_head}

    def _pretrain_config(self):
        from .llama_pretrain import LlamaPretrainConfig
        cfg = self.cfg
        return LlamaPretrainConfig(
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size,
            num_hidden_layers=cfg.num_hidden_layers,
            num_attention_heads=cfg.num_attention_heads,
            num_key_value_heads=cfg.num_key_value_heads,
            max_seq_len=cfg.max_position_embeddings,
            rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
            use_pallas_attention=False, sequence_parallel=False,
            remat=False, dtype=torch.float32, param_dtype=torch.float32)

    def _cached_pretrain_params(self, quantize_int8=False):
        """:meth:`_pretrain_params` (int8-quantized if asked), kept on the
        instance until any parameter's data is rebound or written in place
        (weak references to the data, and their version counters: an
        optimizer step moves both kinds of change)."""
        from .decode import quantize_params_int8
        plist = [p._data for p in self.parameters()]
        sig = [(weakref.ref(d), d._version) for d in plist]
        cached = getattr(self, "_gen_params", None)
        if cached is None or cached[1] != quantize_int8 or \
                len(cached[0]) != len(sig) or any(
                    w() is not d or ver != d._version
                    for (w, ver), d in zip(cached[0], plist)):
            params = self._pretrain_params()
            if quantize_int8:
                params = quantize_params_int8(params)
            self._gen_params = cached = (sig, quantize_int8, params)
        return cached[2]

    def generate_compiled(self, input_ids, max_new_tokens=32,
                          temperature=0.0, quantize_int8=False, seed=0):
        """The dense-cache decode of ``models/decode.py`` over this model's
        weights (``make_generate``, memoised per (prompt length,
        new tokens, temperature)).  It computes in f32 over the weights'
        own type (a bf16 model's matrices are widened at each product), as
        JAX's pins ``dtype=float32``; ``quantize_int8`` serves the weights
        as int8 through the int8 matmul kernel.  ``seed`` seeds the
        sampling generator when ``temperature > 0``.  -> the prompt and
        the new tokens, ``[B, S + max_new_tokens]``."""
        from .decode import make_generate
        ids = input_ids._data if isinstance(input_ids, Tensor) else \
            torch.as_tensor(np.asarray(input_ids))
        ids = ids.to(self.llama.embed_tokens.weight._data.device).long()
        cache = self.__dict__.setdefault("_gen_cache", {})
        key = (int(ids.shape[1]), int(max_new_tokens), float(temperature))
        gen = cache.get(key)
        if gen is None:
            gen = cache[key] = make_generate(
                self._pretrain_config(), prompt_len=key[0],
                max_new_tokens=max_new_tokens, temperature=temperature)
        toks = gen(self._cached_pretrain_params(quantize_int8), ids, seed)
        return wrap_array(torch.cat([ids, toks], dim=1))

    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_p=None):
        """Greedy (or top-p) decode, eager, over a concatenated KV cache.
        The empty caches take the parameters' type and device (JAX's f32
        ``zeros`` would widen a bf16 model's cache)."""
        cfg = self.cfg
        w = self.llama.embed_tokens.weight._data
        with torch.no_grad():
            b = input_ids.shape[0]
            shape = (b, 0, cfg.num_key_value_heads, cfg.head_dim)
            caches = [(wrap_array(torch.zeros(shape, dtype=w.dtype,
                                              device=w.device)),
                       wrap_array(torch.zeros(shape, dtype=w.dtype,
                                              device=w.device)))
                      for _ in range(cfg.num_hidden_layers)]
            logits, caches = self.forward(input_ids, caches=caches)
            tokens = input_ids
            for _ in range(max_new_tokens):
                last = logits[:, -1]
                if top_p is not None:
                    ps = wrap_array(torch.full((b,), float(top_p),
                                               device=w.device))
                    _, nxt = top_p_sampling(last / temperature, ps)
                else:
                    nxt = argmax(last, axis=-1, keepdim=True)
                nxt = reshape(nxt, [b, 1])
                tokens = concat([tokens, nxt], axis=1)
                logits, caches = self.forward(nxt, caches=caches)
            return tokens

