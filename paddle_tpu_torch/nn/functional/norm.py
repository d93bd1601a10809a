"""Normalization functionals (counterpart of
`paddle_tpu/nn/functional/norm.py`).

`batch_norm` in training mode updates the running-statistic Tensors it is
given, off the tape, with paddle's momentum convention:
`running = running * momentum + batch * (1 - momentum)`, the variance
unbiased over the elements a channel averages. `torch.nn.functional
.batch_norm`'s `momentum` weights the other term, so it is not called.
"""
import torch
import torch.nn.functional as TF

from ...core.tensor import apply_op

__all__ = ["batch_norm", "layer_norm", "group_norm", "instance_norm",
           "local_response_norm", "normalize"]


def _ch_axis(ndim, data_format):
    return 1 if data_format.startswith("NC") else ndim - 1


def _affine(out, wb, shape):
    """Scale by wb[0], shift by wb[1]. As in the reference, the operands
    are positional: a bias passed without a weight is read as the
    scale."""
    if len(wb) >= 1 and wb[0] is not None:
        out = out * wb[0].reshape(shape)
    if len(wb) == 2 and wb[1] is not None:
        out = out + wb[1].reshape(shape)
    return out


def _wb_args(weight, bias):
    return [t for t in (weight, bias) if t is not None]


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    axis = _ch_axis(x.ndim, data_format)
    reduce_axes = tuple(i for i in range(x.ndim) if i != axis)
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    shape = [1] * x.ndim
    shape[axis] = -1

    if use_stats:
        def fn(a, rm, rv, *wb):
            out = (a - rm.reshape(shape)) * torch.rsqrt(
                rv.reshape(shape) + epsilon)
            return _affine(out, wb, shape)
        return apply_op(fn, x, running_mean, running_var,
                        *_wb_args(weight, bias), name="batch_norm")

    def fn(a, *wb):
        var, mean = torch.var_mean(a, dim=reduce_axes, unbiased=False)
        out = (a - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + epsilon)
        return _affine(out, wb, shape)
    out = apply_op(fn, x, *_wb_args(weight, bias), name="batch_norm")

    # running statistics, off the tape
    with torch.no_grad():
        a = x._data
        var, mean = torch.var_mean(a, dim=reduce_axes, unbiased=False)
        n = a.numel() // a.shape[axis]
        unbiased = var * (n / max(n - 1, 1))
    running_mean._rebind(lambda r: r * momentum + mean * (1 - momentum),
                         tracked=False)
    running_var._rebind(lambda r: r * momentum + unbiased * (1 - momentum),
                        tracked=False)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    ns = tuple(int(s) for s in normalized_shape)
    if weight is not None and bias is not None:
        return apply_op(lambda a, w, b: TF.layer_norm(a, ns, w, b, epsilon),
                        x, weight, bias, name="layer_norm")
    axes = tuple(range(-len(ns), 0))

    def fn(a, *wb):
        var, mean = torch.var_mean(a, dim=axes, unbiased=False, keepdim=True)
        out = (a - mean) * torch.rsqrt(var + epsilon)
        return _affine(out, wb, ns)
    return apply_op(fn, x, *_wb_args(weight, bias), name="layer_norm")


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    def fn(a, *wb):
        N = a.shape[0]
        if data_format.startswith("NC"):
            C = a.shape[1]
            g = a.reshape((N, num_groups, C // num_groups)
                          + tuple(a.shape[2:]))
            axes = tuple(range(2, g.dim()))
            shape = [1, C] + [1] * (a.dim() - 2)
        else:
            C = a.shape[-1]
            g = a.reshape(tuple(a.shape[:-1]) + (num_groups,
                                                 C // num_groups))
            axes = tuple(range(1, a.dim() - 1)) + (a.dim(),)
            shape = [1] * (a.dim() - 1) + [C]
        var, mean = torch.var_mean(g, dim=axes, unbiased=False, keepdim=True)
        out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(a.shape)
        return _affine(out, wb, shape)
    return apply_op(fn, x, *_wb_args(weight, bias), name="group_norm")


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    cf = data_format.startswith("NC")

    def fn(a, *wb):
        axes = tuple(range(2, a.dim())) if cf else tuple(range(1, a.dim() - 1))
        var, mean = torch.var_mean(a, dim=axes, unbiased=False, keepdim=True)
        out = (a - mean) * torch.rsqrt(var + eps)
        C = a.shape[1] if cf else a.shape[-1]
        shape = [1, C] + [1] * (a.dim() - 2) if cf \
            else [1] * (a.dim() - 1) + [C]
        return _affine(out, wb, shape)
    return apply_op(fn, x, *_wb_args(weight, bias), name="instance_norm")


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    def fn(a):
        ch_axis = 1 if data_format.startswith("NC") else a.dim() - 1
        moved = torch.movedim(a * a, ch_axis, -1)
        half = size // 2
        padded = TF.pad(moved, [half, size - half - 1])
        n = moved.shape[-1]
        win = sum(padded[..., i:i + n] for i in range(size))
        win = torch.movedim(win, -1, ch_axis)
        return a / torch.pow(k + alpha * win, beta)
    return apply_op(fn, x, name="local_response_norm")


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def fn(a):
        if p == 2:
            nrm = torch.sqrt(torch.sum(a * a, dim=axis, keepdim=True))
        else:
            nrm = torch.pow(torch.sum(torch.pow(a.abs(), p), dim=axis,
                                      keepdim=True), 1.0 / p)
        return a / torch.clamp(nrm, min=epsilon)
    return apply_op(fn, x, name="normalize")
