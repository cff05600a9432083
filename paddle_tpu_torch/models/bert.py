"""BERT encoder family — the port of `paddle_tpu/models/bert.py`, whole
(BASELINE.md config 3: BERT-base fine-tune): `BertConfig`,
`bert_base_config`, `BertEmbeddings` (its LayerNorm at
``layer_norm_eps`` = 1e-12), `BertPooler`, `BertModel` and
`BertForSequenceClassification`, built on the port's
`nn.TransformerEncoder`: attention runs through the flash kernels on the
card (non-causal; with ``attention_mask`` the masked branch, a
[B, 1, 1, S] key-padding mask read as a stride-0 view), the LayerNorm
kernels under ``PTPU_PALLAS_LN=1``.

``device`` (None: ``cuda``), ``dtype`` and ``generator`` are keyword-only
and reach every layer (`nn.common`); weights carried from the JAX model
load with `Layer.set_state_dict` under the JAX names
(``bert.encoder.layers.0.self_attn.q_proj.weight``, ...).
"""
from __future__ import annotations

import dataclasses

import torch

from ..nn import functional as F
from ..nn.common import Dropout, Embedding, Linear
from ..nn.layer import Layer
from ..nn.norm import LayerNorm
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer

__all__ = [
    "BertConfig", "BertEmbeddings", "BertPooler", "BertModel",
    "BertForSequenceClassification", "bert_base_config",
]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12


def bert_base_config(**kw):
    return BertConfig(**kw)


class BertEmbeddings(Layer):
    def __init__(self, cfg: BertConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps,
                                    device=device, dtype=dtype)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        seq = input_ids.shape[-1]
        if position_ids is None:
            position_ids = torch.arange(seq, dtype=torch.int32,
                                        device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros(input_ids.shape, dtype=torch.int32,
                                         device=input_ids.device)
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(position_ids)
            + self.token_type_embeddings(token_type_ids)
        )
        return self.dropout(self.layer_norm(x))


class BertPooler(Layer):
    def __init__(self, cfg: BertConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size, device=device,
                            dtype=dtype, generator=generator)

    def forward(self, x):
        return F.tanh(self.dense(x[:, 0]))


class BertModel(Layer):
    def __init__(self, cfg: BertConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, **kw)
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation="gelu",
            attn_dropout=cfg.attention_probs_dropout_prob,
            act_dropout=cfg.hidden_dropout_prob, **kw)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_hidden_layers)
        self.pooler = BertPooler(cfg, **kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        x = self.encoder(x, src_mask=attention_mask)
        return x, self.pooler(x)


class BertForSequenceClassification(Layer):
    def __init__(self, cfg: BertConfig, num_classes=2, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.bert = BertModel(cfg, **kw)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.classifier = Linear(cfg.hidden_size, num_classes, **kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        return self.classifier(self.dropout(pooled))
