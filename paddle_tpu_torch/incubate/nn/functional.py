"""incubate.nn.functional of the port (counterpart of
`paddle_tpu/incubate/nn/functional.py`): the functional forms of the
fused transformer ops, with the reference's signatures and math. The
attention here is dense, as in the reference's functional forms.

Dropout draws its keep mask from the port's generator of the tensor's
device (`core.random`): the same seed gives the same masks within the
port, and the kept fraction is 1 - rate. `jax.random`'s bits cannot be
reproduced in torch (ROADMAP C.14).
"""
import torch

from ...core.random import generator
from ...core.tensor import apply_op

__all__ = ["fused_multi_head_attention", "fused_feedforward",
           "fused_multi_transformer", "fused_matmul_bias", "fused_linear",
           "fused_bias_dropout_residual_layer_norm",
           "fused_linear_cross_entropy"]


def _layer_norm(h, g, b, eps):
    mean = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, unbiased=False)
    out = (h - mean) * torch.rsqrt(var + eps)
    if g is not None:
        out = out * g
    if b is not None:
        out = out + b
    return out


def _dropout(h, rate, training, mode):
    if not training or rate <= 0:
        if mode == "downscale_in_infer" and rate > 0:
            return h * (1 - rate)
        return h
    keep = torch.rand(h.shape, generator=generator(h.device),
                      device=h.device) >= rate
    zero = h.new_zeros(())
    if mode == "upscale_in_train":
        return torch.where(keep, h / (1 - rate), zero)
    return torch.where(keep, h, zero)


def _gelu(u):
    return torch.nn.functional.gelu(u, approximate="tanh")


# `getattr(jax.nn, activation)` in the reference: jax's gelu is the tanh
# approximation
_ACT = {"gelu": _gelu, "relu": torch.relu, "silu": torch.nn.functional.silu,
        "sigmoid": torch.sigmoid, "tanh": torch.tanh}


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """x @ y (+ bias), with optional transposes of the last two dims."""
    def fn(a, b, *bs):
        if transpose_x:
            a = a.transpose(-1, -2)
        if transpose_y:
            b = b.transpose(-1, -2)
        out = a @ b
        return out + bs[0] if bs else out
    args = [x, y] + ([bias] if bias is not None else [])
    return apply_op(fn, *args, name="fused_matmul_bias")


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    return fused_matmul_bias(x, weight, bias, False, transpose_weight)


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None):
    """LayerNorm(residual + dropout(x + bias))."""
    present = tuple(n for n, t in (("b", bias), ("g", ln_scale),
                                   ("be", ln_bias)) if t is not None)

    def fn(xd, rd, *rest):
        named = dict(zip(present, rest))
        h = xd + named["b"] if "b" in named else xd
        h = _dropout(h, dropout_rate, training, mode) + rd
        return _layer_norm(h, named.get("g"), named.get("be"), ln_epsilon)
    args = [x, residual] + [t for t in (bias, ln_scale, ln_bias)
                            if t is not None]
    return apply_op(fn, *args, name="fused_bias_dropout_residual_layer_norm")


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.0,
                               attn_dropout_rate=0.0, ln_epsilon=1e-5,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, num_heads=None,
                               transpose_qkv_wb=False, name=None):
    """[pre-LN ->] qkv projection -> dense attention -> output projection
    [-> residual + LN]. qkv_weight is (3, H, head_dim, hidden), contracted
    on its last axis."""
    present = tuple(n for n, t in (
        ("pre_g", pre_ln_scale), ("pre_b", pre_ln_bias), ("g", ln_scale),
        ("b", ln_bias), ("qkv_b", qkv_bias), ("lin_b", linear_bias),
        ("mask", attn_mask)) if t is not None)

    def fn(xd, qkvw, lw, *rest):
        named = dict(zip(present, rest))
        h = _layer_norm(xd, named.get("pre_g"), named.get("pre_b"),
                        pre_ln_epsilon) if pre_layer_norm else xd
        nh, hd = qkvw.shape[1], qkvw.shape[2]
        qkv = torch.einsum("bsa,tnda->bstnd", h, qkvw)
        if "qkv_b" in named:
            qkv = qkv + named["qkv_b"][None, None]
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        s = q @ k.transpose(-1, -2) / float(hd) ** 0.5
        if "mask" in named:
            s = s + named["mask"]
        p = _dropout(torch.softmax(s, -1), attn_dropout_rate, training, mode)
        o = (p @ v).transpose(1, 2)
        out = o.reshape(o.shape[0], o.shape[1], nh * hd) @ lw
        if "lin_b" in named:
            out = out + named["lin_b"]
        out = _dropout(out, dropout_rate, training, mode)
        if add_residual:
            out = out + xd
        if not pre_layer_norm:
            out = _layer_norm(out, named.get("g"), named.get("b"),
                              ln_epsilon)
        return out

    args = [x, qkv_weight, linear_weight] + [
        t for t in (pre_ln_scale, pre_ln_bias, ln_scale, ln_bias,
                    qkv_bias, linear_bias, attn_mask) if t is not None]
    return apply_op(fn, *args, name="fused_multi_head_attention")


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True, ring_id=-1,
                      mode="upscale_in_train", name=None):
    present = tuple(n for n, t in (
        ("b1", linear1_bias), ("b2", linear2_bias), ("g1", ln1_scale),
        ("lb1", ln1_bias), ("g2", ln2_scale), ("lb2", ln2_bias))
        if t is not None)
    act = _ACT.get(activation) or getattr(torch.nn.functional, activation)

    def fn(xd, w1, w2, *rest):
        named = dict(zip(present, rest))
        h = _layer_norm(xd, named.get("g1"), named.get("lb1"),
                        ln1_epsilon) if pre_layer_norm else xd
        u = h @ w1
        if "b1" in named:
            u = u + named["b1"]
        u = _dropout(act(u), dropout1_rate, training, mode)
        out = u @ w2
        if "b2" in named:
            out = out + named["b2"]
        out = _dropout(out, dropout2_rate, training, mode) + xd
        if not pre_layer_norm:
            out = _layer_norm(out, named.get("g2"), named.get("lb2"),
                              ln2_epsilon)
        return out

    args = [x, linear1_weight, linear2_weight] + [
        t for t in (linear1_bias, linear2_bias, ln1_scale, ln1_bias,
                    ln2_scale, ln2_bias) if t is not None]
    return apply_op(fn, *args, name="fused_feedforward")


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights, qkv_biases,
                            linear_weights, linear_biases, ffn_ln_scales,
                            ffn_ln_biases, ffn1_weights, ffn1_biases,
                            ffn2_weights, ffn2_biases, pre_layer_norm=True,
                            epsilon=1e-05, cache_kvs=None, time_step=None,
                            attn_mask=None, dropout_rate=0.0,
                            activation="gelu", training=False,
                            mode="upscale_in_train", trans_qkvw=True,
                            ring_id=-1, name=None):
    """Pre-LN attention and feed-forward a layer over weight lists."""
    out = x
    for i in range(len(qkv_weights)):
        out = fused_multi_head_attention(
            out, qkv_weights[i], linear_weights[i], pre_layer_norm=True,
            pre_ln_scale=ln_scales[i], pre_ln_bias=ln_biases[i],
            pre_ln_epsilon=epsilon, qkv_bias=qkv_biases[i],
            linear_bias=linear_biases[i], attn_mask=attn_mask,
            dropout_rate=dropout_rate, training=training, mode=mode)
        out = fused_feedforward(
            out, ffn1_weights[i], ffn2_weights[i], ffn1_biases[i],
            ffn2_biases[i], ln1_scale=ffn_ln_scales[i],
            ln1_bias=ffn_ln_biases[i], pre_layer_norm=True,
            dropout1_rate=dropout_rate, dropout2_rate=dropout_rate,
            activation=activation, ln1_epsilon=epsilon, training=training,
            mode=mode)
    return out


def fused_linear_cross_entropy(x, weight, label, num_chunks=8,
                               reduction="mean", name=None):
    """LM-head linear and softmax cross-entropy over vocab chunks, the
    (tokens, vocab) logits never whole (`ops/fused_ce.py`). x: (..., H);
    weight: (V, H); label: (...,) int; reduction "mean" | "sum" |
    "none"."""
    from ...ops.fused_ce import fused_linear_cross_entropy as _op
    from ...nn.functional.loss import _reduce

    def call(xd, w, lab):
        lead = xd.shape[:-1]
        nll = _op(xd.reshape(-1, xd.shape[-1]), w, lab.reshape(-1),
                  int(num_chunks))
        return _reduce(nll.reshape(lead), reduction)

    return apply_op(call, x, weight, label,
                    name="fused_linear_cross_entropy")
