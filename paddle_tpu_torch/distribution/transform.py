"""Distribution transforms of the port (counterpart of
`paddle_tpu/distribution/transform.py`): invertible maps with closed-form
log-det-Jacobians, composable into `TransformedDistribution`. Each
transform is a pair of torch functions on raw tensors; the public methods
take and return Tensors through `apply_op` (recorded by autograd)."""
import math

import torch
import torch.nn.functional as F

from ..core.tensor import Tensor, apply_op, to_tensor

__all__ = [
    "Transform", "AbsTransform", "AffineTransform", "ChainTransform",
    "ExpTransform", "IndependentTransform", "PowerTransform",
    "ReshapeTransform", "SigmoidTransform", "SoftmaxTransform",
    "StackTransform", "StickBreakingTransform", "TanhTransform",
    "TransformedDistribution",
]


def _d(x):
    from . import _d as d
    return d(x)


def _t(x):
    import numpy as np
    return x if isinstance(x, Tensor) else to_tensor(np.asarray(x,
                                                                np.float32))


class Transform:
    """Base invertible transform: subclasses define _forward, _inverse and
    _forward_log_det_jacobian on raw tensors."""

    _event_rank = 0          # rank of the event the jacobian sums over

    def forward(self, x):
        return apply_op(self._forward, _t(x))

    def inverse(self, y):
        return apply_op(self._inverse, _t(y))

    def forward_log_det_jacobian(self, x):
        return apply_op(self._forward_log_det_jacobian, _t(x))

    def inverse_log_det_jacobian(self, y):
        return apply_op(
            lambda v: -self._forward_log_det_jacobian(self._inverse(v)),
            _t(y))

    def __call__(self, x):
        return self.forward(x)


class ExpTransform(Transform):
    def _forward(self, x):
        return torch.exp(x)

    def _inverse(self, y):
        return torch.log(y)

    def _forward_log_det_jacobian(self, x):
        return x


class AbsTransform(Transform):
    """y = |x|; not bijective: the inverse is the positive branch."""

    def _forward(self, x):
        return torch.abs(x)

    def _inverse(self, y):
        return y

    def _forward_log_det_jacobian(self, x):
        return torch.zeros_like(x)


class AffineTransform(Transform):
    def __init__(self, loc, scale):
        self.loc = _d(loc)
        self.scale = _d(scale)

    def _forward(self, x):
        return self.loc + self.scale * x

    def _inverse(self, y):
        return (y - self.loc) / self.scale

    def _forward_log_det_jacobian(self, x):
        return torch.log(torch.abs(self.scale)).expand(x.shape)


class PowerTransform(Transform):
    def __init__(self, power):
        self.power = _d(power)

    def _forward(self, x):
        return torch.pow(x, self.power)

    def _inverse(self, y):
        return torch.pow(y, 1.0 / self.power)

    def _forward_log_det_jacobian(self, x):
        return torch.log(torch.abs(self.power *
                                   torch.pow(x, self.power - 1)))


class SigmoidTransform(Transform):
    def _forward(self, x):
        return torch.sigmoid(x)

    def _inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def _forward_log_det_jacobian(self, x):
        return -F.softplus(-x) - F.softplus(x)


class TanhTransform(Transform):
    def _forward(self, x):
        return torch.tanh(x)

    def _inverse(self, y):
        return torch.atanh(y)

    def _forward_log_det_jacobian(self, x):
        # log(1 - tanh(x)^2) = 2 (log 2 - x - softplus(-2x)), stable
        return 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))


class SoftmaxTransform(Transform):
    """Not bijective: forward is the softmax over the last axis, inverse
    the log."""

    _event_rank = 1

    def _forward(self, x):
        return torch.softmax(x, dim=-1)

    def _inverse(self, y):
        return torch.log(y)

    def _forward_log_det_jacobian(self, x):
        raise NotImplementedError("SoftmaxTransform has no log-det (not "
                                  "bijective)")


def _offset(n, like):
    return torch.log(torch.arange(n, 0, -1, dtype=like.dtype,
                                  device=like.device))


class StickBreakingTransform(Transform):
    """R^n -> the open simplex in R^(n+1) by stick breaking."""

    _event_rank = 1

    def _forward(self, x):
        z = torch.sigmoid(x - _offset(x.shape[-1], x))
        one = x.new_ones(x.shape[:-1] + (1,))
        zpad = torch.cat([z, one], -1)
        one_minus = torch.cat([one, torch.cumprod(1 - z, -1)], -1)
        return zpad * one_minus

    def _inverse(self, y):
        n = y.shape[-1] - 1
        cum = torch.cumsum(y[..., :-1], -1)
        rem = 1.0 - torch.cat([y.new_zeros(y.shape[:-1] + (1,)),
                               cum[..., :-1]], -1)
        z = y[..., :-1] / rem
        return torch.log(z) - torch.log1p(-z) + _offset(n, y)

    def _forward_log_det_jacobian(self, x):
        t = x - _offset(x.shape[-1], x)
        z = torch.sigmoid(t)
        log_sig = -F.softplus(-t) - F.softplus(t)
        rem = torch.cat([x.new_zeros(x.shape[:-1] + (1,)),
                         torch.cumsum(torch.log1p(-z), -1)[..., :-1]], -1)
        return (log_sig + rem).sum(-1)


class ReshapeTransform(Transform):
    def __init__(self, in_event_shape, out_event_shape):
        self.in_event_shape = tuple(in_event_shape)
        self.out_event_shape = tuple(out_event_shape)
        self._event_rank = len(self.in_event_shape)

    def _forward(self, x):
        batch = tuple(x.shape[:x.dim() - len(self.in_event_shape)])
        return x.reshape(batch + self.out_event_shape)

    def _inverse(self, y):
        batch = tuple(y.shape[:y.dim() - len(self.out_event_shape)])
        return y.reshape(batch + self.in_event_shape)

    def _forward_log_det_jacobian(self, x):
        batch = tuple(x.shape[:x.dim() - len(self.in_event_shape)])
        return x.new_zeros(batch)


def _sum_last(t, k):
    return t.sum(tuple(range(t.dim() - k, t.dim()))) if k else t


class IndependentTransform(Transform):
    """Reinterprets batch dims as event dims (sums the jacobian over
    them)."""

    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self.rank = int(reinterpreted_batch_rank)
        self._event_rank = base._event_rank + self.rank

    def _forward(self, x):
        return self.base._forward(x)

    def _inverse(self, y):
        return self.base._inverse(y)

    def _forward_log_det_jacobian(self, x):
        return _sum_last(self.base._forward_log_det_jacobian(x), self.rank)


class ChainTransform(Transform):
    def __init__(self, transforms):
        self.transforms = list(transforms)
        self._event_rank = max((t._event_rank for t in self.transforms),
                               default=0)

    def _forward(self, x):
        for t in self.transforms:
            x = t._forward(x)
        return x

    def _inverse(self, y):
        for t in reversed(self.transforms):
            y = t._inverse(y)
        return y

    def _forward_log_det_jacobian(self, x):
        total = None
        for t in self.transforms:
            ld = t._forward_log_det_jacobian(x)
            extra = self._event_rank - t._event_rank
            if extra and ld.dim() >= extra:
                ld = _sum_last(ld, extra)
            total = ld if total is None else total + ld
            x = t._forward(x)
        return total


class StackTransform(Transform):
    """Applies transforms[i] to slice i along `axis`."""

    def __init__(self, transforms, axis=0):
        self.transforms = list(transforms)
        self.axis = axis

    def _map(self, fn_name, x):
        parts = torch.chunk(x, len(self.transforms), dim=self.axis)
        outs = [getattr(t, fn_name)(p.squeeze(self.axis))
                for t, p in zip(self.transforms, parts)]
        return torch.stack(outs, dim=self.axis)

    def _forward(self, x):
        return self._map("_forward", x)

    def _inverse(self, y):
        return self._map("_inverse", y)

    def _forward_log_det_jacobian(self, x):
        return self._map("_forward_log_det_jacobian", x)


class TransformedDistribution:
    """The distribution of T(X) for X ~ base: log_prob(y) =
    base.log_prob(T^-1(y)) - log|det J_T(T^-1(y))|."""

    def __init__(self, base, transforms):
        self.base = base
        if isinstance(transforms, Transform):
            transforms = [transforms]
        self.transform = ChainTransform(list(transforms)) \
            if len(transforms) != 1 else transforms[0]

    def sample(self, shape=()):
        return self.transform.forward(self.base.sample(shape))

    def rsample(self, shape=()):
        x = getattr(self.base, "rsample", self.base.sample)(shape)
        return self.transform.forward(x)

    def log_prob(self, value):
        x = self.transform.inverse(value)
        base_lp = self.base.log_prob(x)

        def fn(bl, xv):
            ld = self.transform._forward_log_det_jacobian(xv)
            er = self.transform._event_rank
            if er and bl.dim() >= er:
                bl = _sum_last(bl, er)
            return bl - ld
        return apply_op(fn, base_lp, x)
