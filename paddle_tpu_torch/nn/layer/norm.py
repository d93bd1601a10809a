"""Norm layers (counterpart of `paddle_tpu/nn/layer/norm.py`).

A training BatchNorm reduces its batch statistics over the processes of
the process group (`_sync_batch_norm`: sum, sum of squares and count in
f32, one differentiable all-reduce) where the reference's would see more
than the local rows: `SyncBatchNorm` under a process group of world > 1
(the reference's live "dp" axis), and every BatchNorm inside `Model`'s dp
route (`distributed.env.global_batch`), whose one program sees the
global batch in the reference. Otherwise it is the local BatchNorm.
"""
import torch

from ...core.random import generator
from ...core.device import current_device
from ...core.tensor import Tensor, _wrap, apply_op
from .. import functional as F
from ..functional.norm import _affine
from ..initializer import Constant
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                (num_features,), attr=weight_attr,
                default_initializer=Constant(1.0))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter((num_features,), attr=bias_attr,
                                              is_bias=True)
        dev = current_device()
        self.register_buffer("_mean", _wrap(torch.zeros(
            (num_features,), device=dev)), persistable=True)
        self.register_buffer("_variance", _wrap(torch.ones(
            (num_features,), device=dev)), persistable=True)

    def forward(self, x):
        use_stats = (not self.training) if self._use_global_stats is None \
            else self._use_global_stats
        if not use_stats and _syncs(self):
            return _sync_batch_norm(self, x)
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


def _syncs(layer):
    from ...distributed import env
    if env.global_batch_live():
        return True
    return isinstance(layer, SyncBatchNorm) and env.process_group_live()


def _sync_batch_norm(layer, x):
    """Training BatchNorm over the process group's rows: per channel, the
    sum, the sum of squares and the count, in f32, all-reduced (its
    backward all-reduces the cotangent, psum's transpose). The running
    variance is unbiased over the global count, as `F.batch_norm`'s."""
    from ...distributed import env
    from ...distributed.collective import world_sum
    pg = env.global_batch_group() if env.global_batch_live() else None
    ch = 1 if layer._data_format.startswith("NC") else x.ndim - 1
    red = tuple(i for i in range(x.ndim) if i != ch)
    shape = [1] * x.ndim
    shape[ch] = -1
    eps = layer._epsilon

    def fn(a, *wb):
        af = a.float()
        n = torch.full((1,), a.numel() // a.shape[ch], dtype=torch.float32,
                       device=a.device)
        stats = world_sum(torch.cat([af.sum(red), (af * af).sum(red), n]),
                          pg)
        c = a.shape[ch]
        count = stats[2 * c]
        mean = stats[:c] / count
        var = stats[c:2 * c] / count - mean * mean
        out = (af - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + eps)
        out = _affine(out.to(a.dtype), wb, shape)
        return out, mean.detach(), var.detach(), count.detach()

    wb = [t for t in (layer.weight, layer.bias) if t is not None]
    out, mean, var, count = apply_op(fn, x, *wb, name="sync_batch_norm")
    m = layer._momentum
    mean, var, n = mean._data, var._data, float(count._data)
    unbiased = var * (n / max(n - 1, 1))
    layer._mean._rebind(lambda r: r * m + mean.to(r.dtype) * (1 - m),
                        tracked=False)
    layer._variance._rebind(lambda r: r * m + unbiased.to(r.dtype) * (1 - m),
                            tracked=False)
    return out


class BatchNorm(_BatchNormBase):
    """fluid-style BatchNorm(num_channels): acts like BatchNorm2D."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=False, **kw):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BatchNorm: in training under a process group of
    world > 1 its statistics are the group's (`_sync_batch_norm`);
    otherwise it is the local BatchNorm, as the reference's is with no
    live "dp" axis."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        out = layer
        if isinstance(layer, _BatchNormBase) \
                and not isinstance(layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format)
            for name in ("weight", "bias", "_mean", "_variance"):
                src = getattr(layer, name)
                if src is not None:
                    getattr(out, name)._rebind(
                        lambda d, s=src: s._data.detach().clone(),
                        tracked=False)
        for name, sub in list(layer._sub_layers.items()):
            new_sub = cls.convert_sync_batchnorm(sub)
            if new_sub is not sub:
                layer._sub_layers[name] = new_sub
                object.__setattr__(layer, name, new_sub)
        return out


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                self._normalized_shape, attr=weight_attr,
                default_initializer=Constant(1.0))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(self._normalized_shape,
                                              attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = None if weight_attr is False else self.create_parameter(
            (num_channels,), attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_channels,), attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.scale = None if weight_attr is False else self.create_parameter(
            (num_features,), attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_features,), attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """forward(weight) -> weight / sigma_max: the weight reshaped to
    (h, w) with `dim` leading, `power_iters` rounds of u/v power
    iteration (no gradient through them), sigma = u^T W v. As in the
    reference kernel, the stored weight_u / weight_v are not updated, so
    one weight gives one output on every forward."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        self._shape = tuple(int(s) for s in weight_shape)
        h = self._shape[dim]
        w = 1
        for i, s in enumerate(self._shape):
            if i != dim:
                w *= s
        dev = current_device()
        g = generator(dev)
        self.register_buffer("weight_u", Tensor(torch.randn(
            (h,), device=dev, generator=g)))
        self.register_buffer("weight_v", Tensor(torch.randn(
            (w,), device=dev, generator=g)))

    def forward(self, weight):
        dim, iters, eps = self._dim, self._power_iters, self._eps

        def fn(wt, u, v):
            perm = [dim] + [d for d in range(wt.dim()) if d != dim]
            mat = wt.permute(perm).reshape(wt.shape[dim], -1)
            with torch.no_grad():
                m = mat.detach()
                for _ in range(iters):
                    v = m.T @ u
                    v = v / (torch.linalg.vector_norm(v) + eps)
                    u = m @ v
                    u = u / (torch.linalg.vector_norm(u) + eps)
            sigma = torch.sum(u * (mat @ v))
            return wt / sigma

        return apply_op(fn, weight, self.weight_u, self.weight_v,
                        name="spectral_norm")
