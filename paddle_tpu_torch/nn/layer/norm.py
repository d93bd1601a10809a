"""Norm layers (counterpart of `paddle_tpu/nn/layer/norm.py`).

`SyncBatchNorm` reduces its batch statistics over the "dp" axis when one
is live in the reference. The port has no `distributed.env` yet (ROADMAP
A.13f), so it always takes the local path, which is the reference's on a
single device (ROADMAP C.15); `convert_sync_batchnorm` is ported.
"""
import torch

from ...core.random import generator
from ...core.device import current_device
from ...core.tensor import Tensor, _wrap, apply_op
from .. import functional as F
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
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


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
    """Cross-replica BatchNorm. With no "dp" axis (the port has no
    `distributed.env` before A.13f) it is the local BatchNorm, as the
    reference is on one device."""

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
