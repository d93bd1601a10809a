"""Random ops (counterpart of `paddle_tpu/tensor/random.py`).

Every draw comes from the global generator of the device it fills
(`core.random.generator`), so `paddle_tpu_torch.seed(n)` makes the
streams reproducible. Creation ops fill the current place; `_like` and
in-place ops the tensor's device."""
import torch

from ..core import dtype as _dt
from ..core.device import current_device
from ..core.random import generator
from ..core.tensor import Tensor, _wrap
from .creation import _shape

__all__ = ["rand", "randn", "standard_normal", "normal", "uniform",
           "uniform_", "randint", "randint_like", "randperm", "multinomial",
           "bernoulli", "poisson", "exponential_", "normal_"]


def _d(dtype):
    d = _dt.convert_dtype(dtype)
    return d if d is not None else _dt.get_default_dtype()


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype)


def standard_normal(shape, dtype=None, name=None):
    dev = current_device()
    return _wrap(torch.randn(_shape(shape), dtype=_d(dtype), device=dev,
                             generator=generator(dev)))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        ref = mean if isinstance(mean, Tensor) else std
        dev = ref._data.device
        m = mean._data if isinstance(mean, Tensor) else mean
        s = std._data if isinstance(std, Tensor) else std
        shp = torch.broadcast_shapes(tuple(getattr(m, "shape", ())),
                                     tuple(getattr(s, "shape", ())))
        z = torch.randn(shp, dtype=ref._data.dtype, device=dev,
                        generator=generator(dev))
        return _wrap(z * s + m)
    dev = current_device()
    shp = _shape(shape) if shape is not None else ()
    return _wrap(torch.randn(shp, dtype=_dt.get_default_dtype(), device=dev,
                             generator=generator(dev)) * std + mean)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = current_device()
    return _wrap(torch.empty(_shape(shape), dtype=_d(dtype), device=dev)
                 .uniform_(min, max, generator=generator(dev)))


def _refill(x, fill):
    """Rebind x to a fresh draw of its shape and dtype (untracked)."""
    def compute(d):
        return fill(torch.empty_like(d), generator(d.device))
    return x._rebind(compute, tracked=False)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    return _refill(x, lambda t, g: t.uniform_(min, max, generator=g))


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    d = _dt.convert_dtype(dtype) or _dt.int64
    return _wrap(torch.randint(low, high, _shape(shape), dtype=d,
                               device=dev, generator=generator(dev)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = x._data.device
    return _wrap(torch.randint(low, high, tuple(x.shape),
                               dtype=_dt.convert_dtype(dtype) or x.dtype,
                               device=dev, generator=generator(dev)))


def randperm(n, dtype="int64", name=None):
    dev = current_device()
    return _wrap(torch.randperm(n, dtype=_dt.convert_dtype(dtype),
                                device=dev, generator=generator(dev)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    p = x._data.detach()
    return _wrap(torch.multinomial(p, num_samples, replacement,
                                   generator=generator(p.device)))


def bernoulli(x, name=None):
    p = x._data.detach()
    return _wrap(torch.bernoulli(p, generator=generator(p.device)))


def poisson(x, name=None):
    p = x._data.detach()
    return _wrap(torch.poisson(p, generator=generator(p.device)))


def exponential_(x, lam=1.0, name=None):
    return _refill(x, lambda t, g: t.exponential_(lam, generator=g))


def normal_(x, mean=0.0, std=1.0, name=None):
    return _refill(x, lambda t, g: t.normal_(mean, std, generator=g))
