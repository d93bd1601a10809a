"""BERT (counterpart of `paddle_tpu/text/models/bert.py`): the BERT-base
pretraining configuration of BASELINE.md, built on the port's
`nn.TransformerEncoder`, whose attention takes the flash kernels on the
card wherever `sdpa_route` says so (head dim 64 at BERT-base's widths)."""
from dataclasses import dataclass

from ...nn import (Dropout, Embedding, Layer, LayerNorm, Linear, Tanh,
                   TransformerEncoder, TransformerEncoderLayer)
from ...nn import functional as F
from ...nn.initializer import Normal


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02


class BertEmbeddings(Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        init = Normal(0.0, cfg.initializer_range)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         weight_attr=init)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, weight_attr=init)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, weight_attr=init)
        self.layer_norm = LayerNorm(cfg.hidden_size, epsilon=1e-12)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        from ...tensor.creation import arange, zeros
        S = input_ids.shape[1]
        pos = arange(0, S, dtype="int64").unsqueeze(0)
        if token_type_ids is None:
            token_type_ids = zeros(input_ids.shape, dtype="int64")
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos) + \
            self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertPooler(Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)
        self.activation = Tanh()

    def forward(self, hidden_states):
        return self.activation(self.dense(hidden_states[:, 0]))


class Bert(Layer):
    def __init__(self, cfg: BertConfig = None, **kwargs):
        super().__init__()
        cfg = cfg or BertConfig(**kwargs)
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation="gelu",
            attn_dropout=cfg.attention_probs_dropout_prob)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_hidden_layers)
        self.pooler = BertPooler(cfg)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        x = self.encoder(x, attention_mask)
        pooled = self.pooler(x)
        return x, pooled


class BertForPretraining(Layer):
    def __init__(self, cfg: BertConfig = None, **kwargs):
        super().__init__()
        cfg = cfg or BertConfig(**kwargs)
        self.bert = Bert(cfg)
        self.cfg = cfg
        self.mlm_head = Linear(cfg.hidden_size, cfg.vocab_size)
        self.nsp_head = Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None):
        seq, pooled = self.bert(input_ids, token_type_ids)
        return self.mlm_head(seq), self.nsp_head(pooled)

    def loss(self, input_ids, mlm_labels, token_type_ids=None, nsp_labels=None):
        mlm_logits, nsp_logits = self(input_ids, token_type_ids)
        loss = F.cross_entropy(
            mlm_logits.reshape([-1, self.cfg.vocab_size]),
            mlm_labels.reshape([-1]), ignore_index=-1)
        if nsp_labels is not None:
            loss = loss + F.cross_entropy(nsp_logits, nsp_labels)
        return loss
