"""GPT as Paddle Layers (counterpart of ``paddle_tpu/models/gpt.py``).

GPT-3's architecture (Brown et al. 2020): learned positions, pre-LN
blocks, a tanh-GELU MLP and causal attention, which takes the flash
kernels (K6a-c) on the card whenever no padding mask is given.
:func:`gpt3_1p3b_config` is GPT-3 XL.  The projections go through
``make_tp_linear``, a plain ``Linear`` until the port has a mesh (ROADMAP.md
queue 1 item 7).  Parameter names are JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..nn import (Dropout, Embedding, GELU, Layer, LayerList, LayerNorm,
                  Linear)
from ..nn import functional as F
from ..tensor.manipulation import reshape
from ._layers import make_tp_linear, normalize_attn_mask

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "gpt3_1p3b_config"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    dropout_prob: float = 0.0
    tensor_parallel: bool = True

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def gpt3_1p3b_config(**over) -> GPTConfig:
    """GPT-3 XL (1.3B): 24 layers, d=2048, 16 heads."""
    cfg = dict(vocab_size=50304, hidden_size=2048, num_hidden_layers=24,
               num_attention_heads=16, max_position_embeddings=2048)
    cfg.update(over)
    return GPTConfig(**cfg)


def _linear(cfg, in_f, out_f, kind):
    return make_tp_linear(cfg.tensor_parallel, in_f, out_f, kind,
                          has_bias=True)


class GPTAttention(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv_proj = _linear(cfg, cfg.hidden_size,
                                3 * cfg.hidden_size, "col")
        self.out_proj = _linear(cfg, cfg.hidden_size, cfg.hidden_size,
                                "row")

    def forward(self, x, attn_mask=None):
        B, L, _ = x.shape
        qkv = self.qkv_proj(x)
        h = qkv.shape[-1] // 3                  # local width under TP
        n_heads = h // self.cfg.head_dim
        qkv = reshape(qkv, [B, L, 3, n_heads, self.cfg.head_dim])
        q = qkv[:, :, 0]                        # [B, L, H, D]
        k = qkv[:, :, 1]
        v = qkv[:, :, 2]
        # always causal; a padding mask composes with (not replaces) it
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=True)
        out = reshape(out, [B, L, h])
        return self.out_proj(out)


class GPTMLP(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.fc_in = _linear(cfg, cfg.hidden_size,
                             cfg.intermediate_size, "col")
        self.fc_out = _linear(cfg, cfg.intermediate_size,
                              cfg.hidden_size, "row")
        self.act = GELU(approximate=True)

    def forward(self, x):
        return self.fc_out(self.act(self.fc_in(x)))


class GPTDecoderLayer(Layer):
    """Pre-LN block (GPT-2/3 style)."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.hidden_size,
                              epsilon=cfg.layer_norm_epsilon)
        self.attn = GPTAttention(cfg)
        self.ln_2 = LayerNorm(cfg.hidden_size,
                              epsilon=cfg.layer_norm_epsilon)
        self.mlp = GPTMLP(cfg)
        self.drop = Dropout(cfg.dropout_prob)

    def forward(self, x, attn_mask=None):
        x = x + self.drop(self.attn(self.ln_1(x), attn_mask))
        x = x + self.drop(self.mlp(self.ln_2(x)))
        return x


class GPTModel(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = Embedding(cfg.max_position_embeddings,
                             cfg.hidden_size)
        self.drop = Dropout(cfg.dropout_prob)
        self.h = LayerList([GPTDecoderLayer(cfg)
                            for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size,
                              epsilon=cfg.layer_norm_epsilon)

    def forward(self, input_ids, attn_mask=None, position_ids=None):
        from ..tensor.creation import arange
        L = input_ids.shape[-1]
        if L > self.cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {L} exceeds max_position_embeddings "
                f"{self.cfg.max_position_embeddings}")
        if position_ids is None:
            position_ids = arange(0, L, dtype="int64")
        attn_mask = normalize_attn_mask(attn_mask)
        x = self.wte(input_ids) + self.wpe(position_ids)
        x = self.drop(x)
        for blk in self.h:
            x = blk(x, attn_mask)
        return self.ln_f(x)


class GPTForCausalLM(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.gpt = GPTModel(cfg)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                              bias_attr=False)

    def forward(self, input_ids, attn_mask=None):
        return self.lm_head(self.gpt(input_ids, attn_mask))


class GPTPretrainingCriterion(Layer):
    """Shifted next-token cross entropy."""

    def forward(self, logits, labels):
        V = logits.shape[-1]
        return F.cross_entropy(
            reshape(logits[:, :-1, :], [-1, V]),
            reshape(labels[:, 1:], [-1]))
