"""ERNIE 3.0 (counterpart of `paddle_tpu/text/models/ernie.py`): a
BERT-style encoder with a task-id embedding (ERNIE 3.0 Base: 12 layers,
hidden 768, 12 heads, task_type_vocab_size 3) on the port's
`nn.TransformerEncoder`, its sequence-classification and pretraining
heads, and the `ernie_3_base` / `ernie_tiny` factories.

`ernie_pipeline_descs` is the `PipelineLayer` description of ERNIE's
mp+pp hybrid-parallel configuration: the embeddings, the encoder layers
and the MLM head tied to the word embeddings through one
`SharedLayerDesc`.
"""
from dataclasses import dataclass

from ...nn import (Dropout, Embedding, Layer, LayerNorm, Linear, Tanh,
                   TransformerEncoder, TransformerEncoderLayer)
from ...nn import functional as F
from ...nn.initializer import Normal

__all__ = ["Ernie", "ErnieConfig", "ErnieForSequenceClassification",
           "ErnieForPretraining", "ernie_3_base", "ernie_tiny",
           "ernie_3_base_config", "ernie_tiny_config",
           "ernie_pipeline_descs"]


@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    task_type_vocab_size: int = 3     # ERNIE's extra task-id embedding
    use_task_id: bool = True
    initializer_range: float = 0.02


class ErnieEmbeddings(Layer):
    """word + position + token-type (+ task-type) embeddings."""

    def __init__(self, cfg: ErnieConfig):
        super().__init__()
        init = Normal(0.0, cfg.initializer_range)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         weight_attr=init)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size,
                                             weight_attr=init)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size,
                                               weight_attr=init)
        self.task_type_embeddings = Embedding(
            cfg.task_type_vocab_size, cfg.hidden_size,
            weight_attr=init) if cfg.use_task_id else None
        self.layer_norm = LayerNorm(cfg.hidden_size, epsilon=1e-12)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None):
        from ...tensor.creation import arange, zeros
        S = input_ids.shape[1]
        pos = arange(0, S, dtype="int64").unsqueeze(0)
        if token_type_ids is None:
            token_type_ids = zeros(input_ids.shape, dtype="int64")
        x = (self.word_embeddings(input_ids) +
             self.position_embeddings(pos) +
             self.token_type_embeddings(token_type_ids))
        if self.task_type_embeddings is not None:
            if task_type_ids is None:
                task_type_ids = zeros(input_ids.shape, dtype="int64")
            x = x + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.layer_norm(x))


class ErniePooler(Layer):
    def __init__(self, cfg: ErnieConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)
        self.activation = Tanh()

    def forward(self, hidden_states):
        return self.activation(self.dense(hidden_states[:, 0]))


class Ernie(Layer):
    def __init__(self, cfg: ErnieConfig = None, **kwargs):
        super().__init__()
        cfg = cfg or ErnieConfig(**kwargs)
        self.cfg = cfg
        self.embeddings = ErnieEmbeddings(cfg)
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation="gelu",
            attn_dropout=cfg.attention_probs_dropout_prob)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_hidden_layers)
        self.pooler = ErniePooler(cfg)

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None,
                attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids, task_type_ids)
        x = self.encoder(x, attention_mask)
        return x, self.pooler(x)


class ErnieForSequenceClassification(Layer):
    def __init__(self, cfg: ErnieConfig = None, num_classes=2, **kwargs):
        super().__init__()
        cfg = cfg or ErnieConfig(**kwargs)
        self.ernie = Ernie(cfg)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.classifier = Linear(cfg.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None):
        _, pooled = self.ernie(input_ids, token_type_ids)
        return self.classifier(self.dropout(pooled))


class ErnieForPretraining(Layer):
    """Knowledge-masked LM + sentence-order heads."""

    def __init__(self, cfg: ErnieConfig = None, **kwargs):
        super().__init__()
        cfg = cfg or ErnieConfig(**kwargs)
        self.cfg = cfg
        self.ernie = Ernie(cfg)
        self.mlm_head = Linear(cfg.hidden_size, cfg.vocab_size)
        self.sop_head = Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None):
        seq, pooled = self.ernie(input_ids, token_type_ids)
        return self.mlm_head(seq), self.sop_head(pooled)

    def loss(self, input_ids, mlm_labels, token_type_ids=None,
             sop_labels=None):
        mlm_logits, sop_logits = self(input_ids, token_type_ids)
        loss = F.cross_entropy(
            mlm_logits.reshape([-1, self.cfg.vocab_size]),
            mlm_labels.reshape([-1]), ignore_index=-1)
        if sop_labels is not None:
            loss = loss + F.cross_entropy(sop_logits, sop_labels)
        return loss


def ernie_3_base_config(**kw):
    return ErnieConfig(**kw)


def ernie_tiny_config(**kw):
    return ErnieConfig(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=128,
                       max_position_embeddings=128, **kw)


def ernie_3_base(**kw):
    """Model factory (same contract as gpt_*/ppyoloe_* zoo factories)."""
    return Ernie(ernie_3_base_config(**kw))


def ernie_tiny(**kw):
    return Ernie(ernie_tiny_config(**kw))


def ernie_pipeline_descs(cfg: ErnieConfig, loss_fn=None):
    """The desc list for fleet.meta_parallel.PipelineLayer (ERNIE's mp+pp
    hybrid-parallel configuration): embeddings | N encoder layers | tied
    MLM head. The embedding table and the output projection are ONE
    parameter through SharedLayerDesc: the first and last stages share
    the layer object, so both gradients accumulate into the same table."""
    from ...distributed.fleet.meta_parallel import (LayerDesc,
                                                    SharedLayerDesc)

    class _SharedEmbed(Layer):
        """Owns the embedding tables: stage 0's embedding and the last
        stage's vocab projection (tied)."""

        def __init__(self):
            super().__init__()
            self.inner = ErnieEmbeddings(cfg)

        def forward(self, ids):
            return self.inner(ids)

    def _embed_fwd(layer, ids):
        return layer.inner(ids)

    def _head_fwd(layer, x):
        from ...tensor.linalg import matmul
        return matmul(x, layer.inner.word_embeddings.weight,
                      transpose_y=True)

    class _Block(Layer):
        def __init__(self):
            super().__init__()
            self.inner = TransformerEncoderLayer(
                cfg.hidden_size, cfg.num_attention_heads,
                cfg.intermediate_size, dropout=cfg.hidden_dropout_prob,
                activation="gelu",
                attn_dropout=cfg.attention_probs_dropout_prob)

        def forward(self, x):
            return self.inner(x)

    return ([SharedLayerDesc("embed", _SharedEmbed, _embed_fwd)] +
            [LayerDesc(_Block) for _ in range(cfg.num_hidden_layers)] +
            [SharedLayerDesc("embed", _SharedEmbed, _head_fwd)])
