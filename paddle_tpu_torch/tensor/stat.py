"""Statistics ops (counterpart of `paddle_tpu/tensor/stat.py`)."""
import torch

from ..core.tensor import apply_op
from .math import _axis, _dims, _float

__all__ = ["std", "var", "nanmean", "nansum"]


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.std(_float(a), dim=_dims(a, ax),
                                        correction=1 if unbiased else 0,
                                        keepdim=keepdim), x)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.var(_float(a), dim=_dims(a, ax),
                                        correction=1 if unbiased else 0,
                                        keepdim=keepdim), x)


def nanmean(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.nanmean(_float(a), dim=_dims(a, ax),
                                            keepdim=keepdim), x)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.nansum(a, dim=_dims(a, ax),
                                           keepdim=keepdim), x)
