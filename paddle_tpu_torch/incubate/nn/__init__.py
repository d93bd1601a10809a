"""incubate.nn of the port (counterpart of `paddle_tpu/incubate/nn/`):
the fused transformer Layers.

The fusion of the reference Paddle's CUDA ops is not rebuilt here: these
Layers compose the port's `nn` Layers with the reference's signatures and
`state_dict` names. `FusedMultiTransformer` is built on the port's
`nn.MultiHeadAttention`, whose attention follows `sdpa_route`: a full
sequence on the card (prefill, Sq == Sk, S % 128 == 0, head dim 64 / 128
/ 256) runs the hand-written flash forward kernel, and a decode step
over a grown cache takes the plain attention, as the reference takes its
flash kernel and its dense attention on the TPU.
"""
from ...nn.layer.transformer import (  # noqa: F401
    MultiHeadAttention as FusedMultiHeadAttention,
    TransformerEncoderLayer as FusedTransformerEncoderLayer,
)
from ...nn.layer.common import Linear as _Linear
from ...nn.layer.layers import Layer
from ...nn import functional as F

__all__ = ["FusedMultiHeadAttention", "FusedTransformerEncoderLayer",
           "FusedFeedForward", "FusedLinear",
           "FusedBiasDropoutResidualLayerNorm", "FusedMultiTransformer"]


class FusedFeedForward(Layer):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-05, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 name=None):
        super().__init__()
        from ...nn.layer.norm import LayerNorm
        from ...nn.layer.common import Dropout
        self.normalize_before = normalize_before
        self.linear1 = _Linear(d_model, dim_feedforward, linear1_weight_attr,
                               linear1_bias_attr)
        self.linear2 = _Linear(dim_feedforward, d_model, linear2_weight_attr,
                               linear2_bias_attr)
        self.norm = LayerNorm(d_model, epsilon)
        self.dropout = Dropout(dropout_rate)
        self.act_dropout = Dropout(act_dropout_rate
                                   if act_dropout_rate is not None
                                   else dropout_rate)
        self.activation = getattr(F, activation)

    def forward(self, src):
        residual = src
        if self.normalize_before:
            src = self.norm(src)
        out = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        out = residual + self.dropout(out)
        if not self.normalize_before:
            out = self.norm(out)
        return out


class FusedLinear(_Linear):
    """The fused GEMM epilogue's Layer: a Linear (bias and matmul in one
    call)."""


class FusedBiasDropoutResidualLayerNorm(Layer):
    """out = LayerNorm(residual + dropout(x + bias))."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-05, name=None):
        super().__init__()
        from ...nn.layer.norm import LayerNorm
        from ...nn.layer.common import Dropout
        from ...nn.initializer import Constant
        self.embed_dim = embed_dim
        self.linear_bias = None if bias_attr is False else \
            self.create_parameter((embed_dim,), attr=bias_attr, is_bias=True,
                                  default_initializer=Constant(0.0))
        self.norm = LayerNorm(embed_dim, epsilon, weight_attr, bias_attr)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, residual):
        if self.linear_bias is not None:
            x = x + self.linear_bias
        return self.norm(residual + self.dropout(x))

    def extra_repr(self):
        return f"embed_dim={self.embed_dim}"


class FusedMultiTransformer(Layer):
    """Inference transformer stack: pre-LN attention and feed-forward a
    layer, with optional per-layer KV caches for decoding. With `caches`
    (a list, entries None for a fresh cache) forward returns (out,
    new_caches)."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 ln_scale_attrs=None, ln_bias_attrs=None,
                 qkv_weight_attrs=None, qkv_bias_attrs=None,
                 linear_weight_attrs=None, linear_bias_attrs=None,
                 ffn_ln_scale_attrs=None, ffn_ln_bias_attrs=None,
                 ffn1_weight_attrs=None, ffn1_bias_attrs=None,
                 ffn2_weight_attrs=None, ffn2_bias_attrs=None,
                 epsilon=1e-5, num_layers=-1, nranks=1, trans_qkvw=True,
                 ring_id=-1, name=None):
        super().__init__()
        if not normalize_before:
            raise ValueError("FusedMultiTransformer only supports "
                             "normalize_before=True (same as the reference)")
        if isinstance(qkv_weight_attrs, (list, tuple)):
            num_layers = len(qkv_weight_attrs)
        if num_layers <= 0:
            raise ValueError("num_layers must be set (or pass per-layer "
                             "attr lists)")
        from ...nn.layer.norm import LayerNorm
        from ...nn.layer.transformer import MultiHeadAttention
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.activation = activation
        self._eps = epsilon
        self.attns = LayerListHelper([
            MultiHeadAttention(embed_dim, num_heads, dropout=dropout_rate)
            for _ in range(num_layers)])
        self.ffns = LayerListHelper([
            FusedFeedForward(embed_dim, dim_feedforward,
                             dropout_rate=dropout_rate,
                             activation=activation, epsilon=epsilon,
                             normalize_before=True)
            for _ in range(num_layers)])
        self.lns = LayerListHelper([LayerNorm(embed_dim, epsilon)
                              for _ in range(num_layers)])

    def forward(self, src, attn_mask=None, caches=None, time_step=None):
        out = src
        new_caches = [] if caches is not None else None
        for i in range(self.num_layers):
            residual = out
            h = self.lns[i](out)
            if caches is not None:
                cache = caches[i] if i < len(caches) else None
                if cache is None:
                    cache = self.attns[i].gen_cache(h[:, :0])
                h, cache = self.attns[i](h, h, h, attn_mask=attn_mask,
                                         cache=cache)
                new_caches.append(cache)
            else:
                h = self.attns[i](h, h, h, attn_mask=attn_mask)
            out = residual + h
            out = self.ffns[i](out)
        if new_caches is not None:
            return out, new_caches
        return out


def LayerListHelper(layers):
    from ...nn.layer.container import LayerList
    return LayerList(layers)


from . import functional  # noqa: F401,E402
