"""Comparison and logic ops (counterpart of `paddle_tpu/tensor/logic.py`)."""
import operator

import torch

from ..core.tensor import Tensor, _binop, _wrap, apply_op
from .math import _tt

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "equal_all", "allclose", "isclose",
           "logical_and", "logical_or", "logical_xor", "logical_not",
           "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
           "is_empty", "is_tensor"]

_logical_and = _tt(torch.logical_and)
_logical_or = _tt(torch.logical_or)
_logical_xor = _tt(torch.logical_xor)
_bitwise_and = _tt(torch.bitwise_and)
_bitwise_or = _tt(torch.bitwise_or)
_bitwise_xor = _tt(torch.bitwise_xor)


def equal(x, y, name=None):
    return _binop(operator.eq, x, y, "equal")


def not_equal(x, y, name=None):
    return _binop(operator.ne, x, y, "not_equal")


def greater_than(x, y, name=None):
    return _binop(operator.gt, x, y, "greater_than")


def greater_equal(x, y, name=None):
    return _binop(operator.ge, x, y, "greater_equal")


def less_than(x, y, name=None):
    return _binop(operator.lt, x, y, "less_than")


def less_equal(x, y, name=None):
    return _binop(operator.le, x, y, "less_equal")


def equal_all(x, y, name=None):
    return apply_op(lambda a, b: torch.tensor(
        tuple(a.shape) == tuple(b.shape) and bool(torch.equal(a, b)),
        device=a.device), x, y)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op(lambda a, b: torch.tensor(
        bool(torch.allclose(a, b.to(a.dtype), rtol, atol, equal_nan)),
        device=a.device), x, y)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op(lambda a, b: torch.isclose(a, b.to(a.dtype), rtol, atol,
                                               equal_nan), x, y)


def logical_and(x, y, out=None, name=None):
    return _binop(_logical_and, x, y, "logical_and")


def logical_or(x, y, out=None, name=None):
    return _binop(_logical_or, x, y, "logical_or")


def logical_xor(x, y, out=None, name=None):
    return _binop(_logical_xor, x, y, "logical_xor")


def logical_not(x, out=None, name=None):
    return apply_op(torch.logical_not, x)


def bitwise_and(x, y, out=None, name=None):
    return _binop(_bitwise_and, x, y, "bitwise_and")


def bitwise_or(x, y, out=None, name=None):
    return _binop(_bitwise_or, x, y, "bitwise_or")


def bitwise_xor(x, y, out=None, name=None):
    return _binop(_bitwise_xor, x, y, "bitwise_xor")


def bitwise_not(x, out=None, name=None):
    return apply_op(torch.bitwise_not, x)


def is_empty(x, name=None):
    return _wrap(torch.tensor(x.size == 0, device=x._data.device))


def is_tensor(x):
    return isinstance(x, Tensor)
