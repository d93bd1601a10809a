"""Activation functionals (counterpart of
`paddle_tpu/nn/functional/activation.py`), each one expression over torch
ops through `apply_op`. The formulas are the reference's where it spells
them out (selu, hardswish, softplus, mish, ...), so values and gradients
follow it rather than torch's functional of the same name."""
import torch
import torch.nn.functional as TF

from ...core import dtype as _dt
from ...core.random import generator
from ...core.tensor import apply_op
from ...tensor.inplace import _make_inplace

__all__ = ["relu", "relu_", "relu6", "gelu", "silu", "swish", "tanh_",
           "elu_", "softmax_", "sigmoid", "log_sigmoid", "tanh", "softmax",
           "log_softmax", "leaky_relu", "elu", "selu", "celu", "hardswish",
           "hardsigmoid", "hardtanh", "hardshrink", "softshrink",
           "tanhshrink", "softplus", "softsign", "mish", "prelu", "maxout",
           "glu", "gumbel_softmax", "thresholded_relu"]


def relu(x, name=None):
    return apply_op(torch.relu, x, name="relu")


def relu6(x, name=None):
    return apply_op(lambda a: torch.clamp(a, 0.0, 6.0), x, name="relu6")


def gelu(x, approximate=False, name=None):
    mode = "tanh" if approximate else "none"
    return apply_op(lambda a: TF.gelu(a, approximate=mode), x, name="gelu")


def silu(x, name=None):
    return apply_op(TF.silu, x, name="silu")


swish = silu


def sigmoid(x, name=None):
    return apply_op(torch.sigmoid, x, name="sigmoid")


def log_sigmoid(x, name=None):
    return apply_op(TF.logsigmoid, x, name="log_sigmoid")


def tanh(x, name=None):
    return apply_op(torch.tanh, x, name="tanh")


def _cast(a, dtype):
    return a if dtype is None else a.to(_dt.convert_dtype(dtype))


def softmax(x, axis=-1, dtype=None, name=None):
    return apply_op(lambda a: torch.softmax(_cast(a, dtype), axis), x,
                    name="softmax")


def log_softmax(x, axis=-1, dtype=None, name=None):
    return apply_op(lambda a: torch.log_softmax(_cast(a, dtype), axis), x,
                    name="log_softmax")


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply_op(lambda a: torch.where(a >= 0, a, a * negative_slope), x,
                    name="leaky_relu")


def elu(x, alpha=1.0, name=None):
    return apply_op(lambda a: torch.where(a > 0, a, alpha * torch.expm1(a)),
                    x, name="elu")


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply_op(lambda a: scale * torch.where(a > 0, a,
                                                  alpha * torch.expm1(a)),
                    x, name="selu")


def celu(x, alpha=1.0, name=None):
    return apply_op(lambda a: TF.celu(a, alpha), x, name="celu")


def hardswish(x, name=None):
    return apply_op(lambda a: a * torch.clamp(a + 3.0, 0.0, 6.0) / 6.0, x,
                    name="hardswish")


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply_op(lambda a: torch.clamp(a * slope + offset, 0.0, 1.0), x,
                    name="hardsigmoid")


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply_op(lambda a: torch.clamp(a, min, max), x, name="hardtanh")


def hardshrink(x, threshold=0.5, name=None):
    return apply_op(lambda a: torch.where(a.abs() > threshold, a, 0.0), x,
                    name="hardshrink")


def softshrink(x, threshold=0.5, name=None):
    return apply_op(lambda a: torch.where(
        a > threshold, a - threshold,
        torch.where(a < -threshold, a + threshold, 0.0)), x,
        name="softshrink")


def tanhshrink(x, name=None):
    return apply_op(lambda a: a - torch.tanh(a), x, name="tanhshrink")


def softplus(x, beta=1, threshold=20, name=None):
    return apply_op(lambda a: torch.where(
        a * beta > threshold, a, torch.log1p(torch.exp(beta * a)) / beta), x,
        name="softplus")


def softsign(x, name=None):
    return apply_op(lambda a: a / (1 + a.abs()), x, name="softsign")


def mish(x, name=None):
    return apply_op(lambda a: a * torch.tanh(
        torch.logaddexp(a, torch.zeros_like(a))), x, name="mish")


def prelu(x, weight, data_format="NCHW", name=None):
    def fn(a, w):
        if w.numel() == 1:
            w_b = w.reshape(())
        else:
            ax = 1 if data_format == "NCHW" else a.dim() - 1
            shape = [1] * a.dim()
            shape[ax] = w.numel()
            w_b = w.reshape(shape)
        return torch.where(a > 0, a, a * w_b)
    return apply_op(fn, x, weight, name="prelu")


def maxout(x, groups, axis=1, name=None):
    def fn(a):
        c = a.shape[axis]
        new_shape = list(a.shape)
        new_shape[axis:axis + 1] = [c // groups, groups]
        return a.reshape(new_shape).amax(dim=axis + 1)
    return apply_op(fn, x, name="maxout")


def glu(x, axis=-1, name=None):
    def fn(a):
        u, v = torch.chunk(a, 2, dim=axis)
        return u * torch.sigmoid(v)
    return apply_op(fn, x, name="glu")


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Gumbel noise drawn from the device generator of x (contract-held:
    same seed, same draw)."""
    def fn(a):
        u = torch.rand(a.shape, dtype=torch.float32, device=a.device,
                       generator=generator(a.device))
        tiny = torch.finfo(torch.float32).tiny
        g = (-torch.log(-torch.log(u.clamp_min(tiny)))).to(a.dtype)
        y = torch.softmax((a + g) / temperature, axis)
        if hard:
            idx = y.argmax(dim=axis, keepdim=True)
            y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
            y = (y_hard - y).detach() + y
        return y
    return apply_op(fn, x, name="gumbel_softmax")


def thresholded_relu(x, threshold=1.0, name=None):
    return apply_op(lambda a: torch.where(a > threshold, a, 0.0), x,
                    name="thresholded_relu")


# in-place variants: the op recorded like the eager core's `op_` variants
# (a trainable leaf raises)
relu_ = _make_inplace(relu, "relu_")
tanh_ = _make_inplace(tanh, "tanh_")
elu_ = _make_inplace(elu, "elu_")
softmax_ = _make_inplace(softmax, "softmax_")
