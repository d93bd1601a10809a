"""Creation ops (counterpart of `paddle_tpu/tensor/creation.py`).

Every op makes its tensor on the current place (`core.device`): the GPU
unless `set_device("cpu")` was called. Integer ranges are int64 (the
JAX package's int32, ROADMAP C.14)."""
import numpy as np
import torch

from ..core import dtype as _dt
from ..core.device import current_device
from ..core.tensor import Tensor, _wrap, apply_op, to_tensor  # noqa: F401

__all__ = ["zeros", "ones", "full", "empty", "zeros_like", "ones_like",
           "full_like", "empty_like", "arange", "linspace", "logspace",
           "eye", "diag", "diagflat", "tril", "triu", "meshgrid", "assign",
           "clone", "complex", "tolist", "to_tensor"]


def _d(dtype):
    d = _dt.convert_dtype(dtype)
    return d if d is not None else _dt.get_default_dtype()


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy().reshape(-1))
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def zeros(shape, dtype=None, name=None):
    return _wrap(torch.zeros(_shape(shape), dtype=_d(dtype),
                             device=current_device()))


def ones(shape, dtype=None, name=None):
    return _wrap(torch.ones(_shape(shape), dtype=_d(dtype),
                            device=current_device()))


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    return _wrap(torch.full(_shape(shape), fill_value, dtype=_d(dtype),
                            device=current_device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    d = _dt.convert_dtype(dtype)
    return apply_op(lambda a: torch.zeros_like(a, dtype=d), x)


def ones_like(x, dtype=None, name=None):
    d = _dt.convert_dtype(dtype)
    return apply_op(lambda a: torch.ones_like(a, dtype=d), x)


def full_like(x, fill_value, dtype=None, name=None):
    d = _dt.convert_dtype(dtype)
    return apply_op(lambda a: torch.full_like(a, fill_value, dtype=d), x)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    for v in (start, end, step):
        if isinstance(v, Tensor):
            raise TypeError("arange over Tensor bounds is not supported; "
                            "pass numbers")
    if end is None:
        start, end = 0, start
    if dtype is None:
        if all(isinstance(v, (int, np.integer)) for v in (start, end, step)):
            dtype = _dt.int64
        else:
            dtype = _dt.get_default_dtype()
    return _wrap(torch.arange(start, end, step, dtype=_d(dtype),
                              device=current_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return _wrap(torch.linspace(start, stop, int(num), dtype=_d(dtype),
                                device=current_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _wrap(torch.logspace(start, stop, int(num), base=base,
                                dtype=_d(dtype), device=current_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    m = num_rows if num_columns is None else num_columns
    return _wrap(torch.eye(num_rows, m, dtype=_d(dtype),
                           device=current_device()))


def diag(x, offset=0, padding_value=0, name=None):
    def fn(a):
        if a.dim() == 1:
            out = torch.diag(a, offset)
            if padding_value != 0:
                mask = torch.diag(torch.ones_like(a), offset).bool()
                out = torch.where(mask, out, padding_value)
            return out
        return torch.diagonal(a, offset)
    return apply_op(fn, x)


def diagflat(x, offset=0, name=None):
    return apply_op(lambda a: torch.diagflat(a, offset), x)


def tril(x, diagonal=0, name=None):
    return apply_op(lambda a: torch.tril(a, diagonal), x)


def triu(x, diagonal=0, name=None):
    return apply_op(lambda a: torch.triu(a, diagonal), x)


def meshgrid(*args, **kwargs):
    tensors = args[0] if len(args) == 1 and isinstance(args[0],
                                                       (list, tuple)) else args
    tensors = [t if isinstance(t, Tensor) else to_tensor(t) for t in tensors]
    return list(apply_op(lambda *xs: torch.meshgrid(*xs, indexing="ij"),
                         *tensors))


def assign(x, output=None):
    src = to_tensor(x) if not isinstance(x, Tensor) else x.clone()
    if output is not None:
        return output._rebind(lambda _: src._data, tracked=False)
    return src


def clone(x, name=None):
    return x.clone()


def complex(real, imag, name=None):
    return apply_op(torch.complex, real, imag)


def tolist(x):
    return x.tolist()
