"""Initializers (counterpart of `paddle_tpu/nn/initializer/__init__.py`).

Each initializer is a callable (shape, dtype, device=None) -> torch
tensor on `device` (default: the current place), drawing from the global
generator of that device (`core.random.generator`), so
`paddle_tpu_torch.seed()` makes initialization reproducible. Draws are
made in float32 and cast, as in the reference. `jax.random` bits cannot
be reproduced, so the random initializers are held by their contract
(ROADMAP C.15): same seed, same values; shape and dtype; bounds and
moments against the formula.

The fans follow paddle's weight layout: a 2-D weight is [in, out], so
fan_in = shape[0] (`_compute_fans`); a conv weight is [out, in, k...].
`torch.nn.init` reads a 2-D weight the other way round and is not used.
"""
import math

import numpy as np
import torch

from ...core import dtype as _dt
from ...core.device import place_device
from ...core.random import generator
from ...core.tensor import Tensor

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Orthogonal", "Dirac", "Bilinear",
           "calculate_gain", "set_global_initializer"]


def _dtype(dtype):
    d = _dt.convert_dtype(dtype)
    return d if d is not None else _dt.get_default_dtype()


class Initializer:
    def __call__(self, shape, dtype, device=None):
        raise NotImplementedError

    def _compute_fans(self, shape):
        if len(shape) == 0:
            return 1, 1
        if len(shape) == 1:
            return shape[0], shape[0]
        if len(shape) == 2:
            return shape[0], shape[1]
        receptive = int(np.prod(shape[2:]))
        return shape[1] * receptive, shape[0] * receptive


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device=None):
        return torch.full(tuple(shape), self.value, dtype=_dtype(dtype),
                          device=place_device(device))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device=None):
        dev = place_device(device)
        z = torch.randn(tuple(shape), dtype=torch.float32, device=dev,
                        generator=generator(dev))
        return (z * self.std + self.mean).to(_dtype(dtype))


class TruncatedNormal(Initializer):
    """Normal truncated to [-2, 2] standard deviations, drawn by inverting
    the CDF on a uniform draw (as `jax.random.truncated_normal` does)."""

    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device=None):
        dev = place_device(device)
        lo, hi = (math.erf(b / math.sqrt(2.0)) for b in (-2.0, 2.0))
        u = torch.empty(tuple(shape), dtype=torch.float32, device=dev) \
            .uniform_(lo, hi, generator=generator(dev))
        z = (math.sqrt(2.0) * torch.erfinv(u)).clamp(-2.0, 2.0)
        return (z * self.std + self.mean).to(_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device=None):
        dev = place_device(device)
        u = torch.empty(tuple(shape), dtype=torch.float32, device=dev) \
            .uniform_(self.low, self.high, generator=generator(dev))
        return u.to(_dtype(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, shape, dtype, device=None):
        fi, fo = self._compute_fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return Normal(0.0, math.sqrt(2.0 / (fi + fo)))(shape, dtype, device)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, shape, dtype, device=None):
        fi, fo = self._compute_fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, device)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device=None):
        fi, _ = self._compute_fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return Normal(0.0, gain / math.sqrt(fi))(shape, dtype, device)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device=None):
        fi, _ = self._compute_fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, device)


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype, device=None):
        dev = place_device(device)
        if isinstance(self.value, Tensor):
            v = self.value._data.detach().to(dev)
        else:
            a = np.asarray(self.value)
            v = torch.as_tensor(a.astype(np.float32) if a.dtype == np.float64
                                else a, device=dev)
        return v.reshape(tuple(shape)).to(_dtype(dtype)).clone()


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, shape, dtype, device=None):
        dev = place_device(device)
        rows, cols = shape[0], int(np.prod(shape[1:]))
        mat = torch.randn((max(rows, cols), min(rows, cols)),
                          dtype=torch.float32, device=dev,
                          generator=generator(dev))
        q, r = torch.linalg.qr(mat)
        q = q * torch.sign(torch.diagonal(r))
        q = q.T if rows < cols else q
        return (self.gain * q[:rows, :cols].reshape(tuple(shape))) \
            .to(_dtype(dtype))


class Dirac(Initializer):
    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype, device=None):
        out = np.zeros(shape, dtype=np.float32)
        out_ch, in_ch = shape[0], shape[1]
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(min(out_ch // self.groups, in_ch)):
                idx = (g * (out_ch // self.groups) + i, i) + tuple(centers)
                out[idx] = 1.0
        return torch.from_numpy(out).to(place_device(device), _dtype(dtype))


_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def calculate_gain(nonlinearity, param=None):
    """Reference fluid/initializer.py: param=0 is a valid leaky slope
    (gain sqrt(2)), only None defaults to 0.01, and unknown names
    raise."""
    param = 0.01 if param is None else float(param)
    table = {
        "sigmoid": 1.0, "linear": 1.0,
        "conv1d": 1.0, "conv2d": 1.0, "conv3d": 1.0,
        "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0,
        "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + param ** 2)),
        "selu": 3.0 / 4,
    }
    if nonlinearity not in table:
        raise ValueError(
            f"nonlinearity function {nonlinearity} is not suppported now.")
    return table[nonlinearity]


class Bilinear(Initializer):
    """Bilinear-upsampling kernel for transposed convs: a weight of shape
    (C_out, C_in, kH, kW) gets the separable triangle filter."""

    def __call__(self, shape, dtype, device=None):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        kh, kw = shape[2], shape[3]
        fh, fw = (kh + 1) // 2, (kw + 1) // 2
        ch = (2 * fh - 1 - fh % 2) / (2.0 * fh)
        cw = (2 * fw - 1 - fw % 2) / (2.0 * fw)
        yy, xx = np.meshgrid(np.arange(kh), np.arange(kw), indexing="ij")
        filt = (1 - abs(yy / fh - ch)) * (1 - abs(xx / fw - cw))
        w = np.zeros(shape, np.float32)
        w[:, :] = filt
        return torch.from_numpy(w).to(place_device(device), _dtype(dtype))
