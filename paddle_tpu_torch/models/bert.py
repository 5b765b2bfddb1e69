"""BERT as Paddle Layers (counterpart of ``paddle_tpu/models/bert.py``).

The post-LN encoder of Devlin et al. 2019: word + position + token-type
embeddings, multi-head self-attention, a GELU FFN and the pooler, with the
sequence-classification and extractive-QA (SQuAD start / end logits)
heads.  ``BertConfig()``'s defaults are BERT-base.  Parameter names are
JAX's, so ``models.weights.layer_state_from_jax`` loads a JAX model's
``state_dict()``.  The attention is ``F.scaled_dot_product_attention``:
with a padding mask its einsum composite, without one the flash kernels
(K6a-c, non-causal) on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..nn import (Dropout, Embedding, GELU, Layer, LayerList, LayerNorm,
                  Linear, Tanh)
from ..nn import functional as F
from ..tensor.manipulation import reshape
from ._layers import normalize_attn_mask

__all__ = ["BertConfig", "BertModel", "BertForSequenceClassification",
           "BertForQuestionAnswering", "bert_base_config"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout_prob: float = 0.0

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def bert_base_config(**over) -> BertConfig:
    return BertConfig(**over)      # the dataclass defaults ARE base


class BertEmbeddings(Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        from ..tensor.creation import arange, zeros_like
        L = input_ids.shape[-1]
        if position_ids is None:
            position_ids = arange(0, L, dtype="int64")
        if token_type_ids is None:
            token_type_ids = zeros_like(input_ids)
        x = self.word_embeddings(input_ids) \
            + self.position_embeddings(position_ids) \
            + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.out = Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x, attn_mask=None):
        B, L, H = x.shape
        qkv = reshape(self.qkv(x),
                      [B, L, 3, self.cfg.num_attention_heads,
                       self.cfg.head_dim])
        out = F.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
            attn_mask=attn_mask)
        return self.out(reshape(out, [B, L, H]))


class BertEncoderLayer(Layer):
    """Post-LN (original BERT)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attn = BertSelfAttention(cfg)
        self.ln_1 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.act = GELU()
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size)
        self.ln_2 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.drop = Dropout(cfg.dropout_prob)

    def forward(self, x, attn_mask=None):
        x = self.ln_1(x + self.drop(self.attn(x, attn_mask)))
        x = self.ln_2(x + self.drop(self.fc2(self.act(self.fc1(x)))))
        return x


class BertPooler(Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)
        self.activation = Tanh()

    def forward(self, hidden):
        return self.activation(self.dense(hidden[:, 0]))


class BertModel(Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = LayerList([BertEncoderLayer(cfg)
                                  for _ in range(cfg.num_hidden_layers)])
        self.pooler = BertPooler(cfg)

    def forward(self, input_ids, token_type_ids=None, attn_mask=None,
                position_ids=None):
        L = input_ids.shape[-1]
        if L > self.cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {L} exceeds max_position_embeddings "
                f"{self.cfg.max_position_embeddings}")
        # accepts the PaddleNLP-style [B, L] 0/1 padding mask
        attn_mask = normalize_attn_mask(attn_mask)
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for blk in self.encoder:
            x = blk(x, attn_mask)
        return x, self.pooler(x)


class BertForSequenceClassification(Layer):
    def __init__(self, cfg: BertConfig, num_classes: int = 2):
        super().__init__()
        self.bert = BertModel(cfg)
        self.dropout = Dropout(cfg.dropout_prob)
        self.classifier = Linear(cfg.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attn_mask)
        return self.classifier(self.dropout(pooled))


class BertForQuestionAnswering(Layer):
    """SQuAD head: per-token start/end logits (BASELINE config 3)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.bert = BertModel(cfg)
        self.qa_outputs = Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        seq, _ = self.bert(input_ids, token_type_ids, attn_mask)
        logits = self.qa_outputs(seq)           # [B, L, 2]
        return logits[:, :, 0], logits[:, :, 1]
