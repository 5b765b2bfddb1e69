"""Transformer layers (counterpart of
``paddle_tpu/nn/layer/transformer.py``): ``MultiHeadAttention`` (with
``cache`` / ``gen_cache`` for incremental decoding), the encoder and decoder
layers (post-norm, or pre-norm with ``normalize_before``),
``TransformerEncoder``, ``TransformerDecoder`` and ``Transformer``.

``MultiHeadAttention`` passes its mask and its attention dropout to
``F.scaled_dot_product_attention``, whose route (``F.sdpa_route``) keeps
JAX's conditions: any mask or dropout takes the einsum composite, a cached
step (q_len 1 against kv_len t) the plain attention, so the Transformer
reaches no hand-written kernel; an unmasked, dropout-free self-attention
over a power-of-two-blockable length at bf16 and head_dim 64 / 128 reaches
K6a-c.  The stacks deep-copy their first layer, as JAX's do, so every
layer starts from the same weights.  The four projections keep JAX's
names (``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``), so a JAX
``state_dict()`` loads unchanged.
"""

from __future__ import annotations

import copy
import math

import torch

from ...framework import place as places
from ...tensor.creation import zeros
from ...tensor.manipulation import concat, reshape
from ...tensor.tensor import wrap_array
from .. import functional as F
from .common import Dropout, Linear
from .layers import Layer, LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(Layer):
    Cache = tuple
    StaticCache = tuple

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """[b, s, embed] -> [b, s, embed]; with ``cache`` (k, v [b, t, h,
        d]) the new keys and values are appended after it and ``(out,
        (k, v))`` returned."""
        key = query if key is None else key
        value = query if value is None else value
        b, sq = query.shape[0], query.shape[1]
        hd = [self.num_heads, self.head_dim]
        q = reshape(self.q_proj(query), [b, sq] + hd)
        k = reshape(self.k_proj(key), [b, key.shape[1]] + hd)
        v = reshape(self.v_proj(value), [b, value.shape[1]] + hd)
        if cache is not None:
            pk, pv = cache
            k = concat([pk, k], axis=1)
            v = concat([pv, v], axis=1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        out = self.out_proj(reshape(out, [b, sq, self.embed_dim]))
        return out if cache is None else (out, (k, v))

    def gen_cache(self, key, value=None, type=None):
        """An empty cache: k and v [b, 0, heads, head_dim]."""
        b = key.shape[0]
        shape = [b, 0, self.num_heads, self.head_dim]
        return zeros(shape, dtype=key.dtype), zeros(shape, dtype=key.dtype)


def _ffn_parts(layer, d_model, dim_feedforward, dropout, activation,
               act_dropout, weight_attr, bias_attr, n_norms,
               layer_norm_eps):
    layer.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
    layer.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
    for i in range(1, n_norms + 1):
        setattr(layer, f"norm{i}", LayerNorm(d_model,
                                             epsilon=layer_norm_eps))
    for i in range(1, n_norms + 1):
        setattr(layer, f"dropout{i}", Dropout(dropout))
    layer.act_dropout = Dropout(act_dropout)
    layer.activation = getattr(F, activation)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        _ffn_parts(self, d_model, dim_feedforward, dropout, activation,
                   act_dropout, weight_attr, bias_attr, 2, layer_norm_eps)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer if i == 0 else copy.deepcopy(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask=src_mask)
            else:
                output, c = mod(output, src_mask=src_mask, cache=cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        _ffn_parts(self, d_model, dim_feedforward, dropout, activation,
                   act_dropout, weight_attr, bias_attr, 3, layer_norm_eps)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, new_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                            cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self.activation(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (new_cache,))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),)


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer if i == 0 else copy.deepcopy(decoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask=tgt_mask,
                             memory_mask=memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask=tgt_mask,
                                memory_mask=memory_mask, cache=cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    """The defaults are Transformer-base (Vaswani et al. 2017, Table 3):
    6 + 6 layers, d_model 512, 8 heads, d_ff 2048, dropout 0.1."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """[length, length] f32 on the current place: 0 on and below the
        diagonal, -inf above."""
        dev = places.current_torch_device()
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=dev).tril()
        return wrap_array(torch.where(keep, 0.0, -math.inf).to(
            torch.float32))
