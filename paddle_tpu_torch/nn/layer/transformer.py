"""Transformer layers (counterpart of `paddle_tpu/nn/layer/transformer.py`).

The attention core is `F.scaled_dot_product_attention`, which runs the
port's flash kernels on the card wherever the reference's rule would run
its Pallas kernels (`nn/functional/attention.py`). A bool mask becomes
an additive one in the query's dtype (True = keep; masked positions take
float32's minimum, which rounds to -inf in bfloat16).

Decode caches: the reference's growing `Cache` (one concat a step; its
keys outgrow the queries, so SDPA takes the plain route), `StaticCache`
for cross-attention, and `StaticDecodeCache` over the port's
`serving/kv_cache.py` (`alloc_kv`, `write`, `attend`): preallocated
buffers written at per-slot positions.
"""
import collections
import copy

import torch

from ...core.device import current_device
from ...core.tensor import _wrap, apply_op
from ...serving import kv_cache as _kvc
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]

_F32_MIN = torch.finfo(torch.float32).min


def _convert_attention_mask(attn_mask, dtype):
    """Bool masks become additive float masks (True = keep); float masks
    pass through in the compute dtype."""
    if attn_mask is None:
        return None
    if attn_mask.dtype != torch.bool:
        return attn_mask.astype(dtype)
    return apply_op(lambda m: torch.where(m, 0.0, _F32_MIN).to(dtype),
                    attn_mask, name="convert_attention_mask")


def _sublayer(x, norm, pre_norm, dropout, fn):
    """One residual sublayer in either norm order: pre-norm normalizes on
    the way in, post-norm on the way out."""
    y = fn(norm(x) if pre_norm else x)
    y = x + dropout(y)
    return y if pre_norm else norm(y)


def _write(buf, new, pos):
    """kv_cache.write into a copy: the cache Tensors keep value
    semantics."""
    return _kvc.write(buf.clone(), new, pos)


class MultiHeadAttention(Layer):
    """Cache protocol: gen_cache() -> Cache / StaticCache, and forward
    returns (out, new_cache) whenever a cache is passed;
    `gen_static_decode_cache` makes the fixed-shape decode cache."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])
    StaticDecodeCache = collections.namedtuple(
        "StaticDecodeCache", ["k", "v", "pos"])

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

    def _heads(self, t, proj):
        """Project and split into [batch, seq, heads, head_dim]."""
        return proj(t).reshape([t.shape[0], -1, self.num_heads,
                                self.head_dim])

    def _kv(self, key, value):
        return self._heads(key, self.k_proj), self._heads(value, self.v_proj)

    def gen_cache(self, key, value=None, type=None):
        """StaticCache projects (key, value) once for cross-attention; the
        default Cache is seeded from pre-projected k/v, or starts empty
        when value is None."""
        if type is self.StaticCache:
            return self.StaticCache(*self._kv(key, value if value is not None
                                              else key))
        if value is not None:
            return self.Cache(key, value)
        empty = _wrap(torch.zeros((key.shape[0], 0, self.num_heads,
                                   self.head_dim), dtype=key.dtype,
                                  device=key._data.device))
        return self.Cache(empty, empty)

    def gen_static_decode_cache(self, batch, max_len, dtype=None):
        """Preallocated decode cache: [batch, max_len, heads, head_dim]
        zeros and per-slot positions at 0, on the current place."""
        dev = current_device()
        raw = _kvc.alloc_kv(batch, max_len, self.num_heads, self.head_dim,
                            dtype or self.k_proj.weight.dtype, device=dev)
        return self.StaticDecodeCache(
            _wrap(raw.k), _wrap(raw.v),
            _wrap(torch.zeros((batch,), dtype=torch.int32, device=dev)))

    def _decode_step(self, q, key, value, cache):
        """Static-cache path: write the new tokens' k/v at each slot's
        position and attend over the whole buffer under the position mask
        (causal within the written prefix)."""
        k_new, v_new = self._kv(key, value)
        k_buf = apply_op(_write, cache.k, k_new, cache.pos, name="kv_write")
        v_buf = apply_op(_write, cache.v, v_new, cache.pos, name="kv_write")
        ctx = apply_op(_kvc.attend, q, k_buf, v_buf, cache.pos,
                       name="kv_attend")
        out = self.out_proj(ctx.reshape([q.shape[0], -1, self.embed_dim]))
        return out, self.StaticDecodeCache(k_buf, v_buf,
                                           cache.pos + q.shape[1])

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._heads(query, self.q_proj)

        if isinstance(cache, self.StaticDecodeCache):
            return self._decode_step(q, key, value, cache)
        if isinstance(cache, self.StaticCache):
            # cross-attention: k/v were projected at gen_cache time; every
            # non-None cache round-trips
            k, v, out_cache = cache.k, cache.v, cache
        elif isinstance(cache, self.Cache):
            from ...tensor.manipulation import concat
            fresh = self._kv(key, value)
            k = concat([cache.k, fresh[0]], axis=1)
            v = concat([cache.v, fresh[1]], axis=1)
            out_cache = self.Cache(k, v)
        else:
            k, v = self._kv(key, value)
            out_cache = None

        ctx = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attention_mask(attn_mask, q.dtype),
            dropout_p=self.dropout, training=self.training)
        out = self.out_proj(ctx.reshape([query.shape[0], -1,
                                         self.embed_dim]))
        return out if out_cache is None else (out, out_cache)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def _ffn(self, h):
        return self.linear2(self.dropout_act(self.activation(
            self.linear1(h))))

    def forward(self, src, src_mask=None, cache=None):
        pre = self.normalize_before
        src = _sublayer(src, self.norm1, pre, self.dropout1,
                        lambda h: self.self_attn(h, h, h, src_mask))
        return _sublayer(src, self.norm2, pre, self.dropout2, self._ffn)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        return out if self.norm is None else self.norm(out)


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
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
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def _ffn(self, h):
        return self.linear2(self.dropout_act(self.activation(
            self.linear1(h))))

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        pre = self.normalize_before
        tgt = _sublayer(tgt, self.norm1, pre, self.dropout1,
                        lambda h: self.self_attn(h, h, h, tgt_mask))
        tgt = _sublayer(tgt, self.norm2, pre, self.dropout2,
                        lambda h: self.cross_attn(h, memory, memory,
                                                  memory_mask))
        return _sublayer(tgt, self.norm3, pre, self.dropout3, self._ffn)


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask, memory_mask)
        return out if self.norm is None else self.norm(out)


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """[length, length] additive causal mask on the current place:
        0 on and below the diagonal, float32's minimum above."""
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=current_device()).tril()
        return _wrap(torch.where(keep, 0.0, _F32_MIN))
