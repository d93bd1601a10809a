"""Dtypes of the eager surface: `torch.dtype`s under paddle's names.

Counterpart of `paddle_tpu/core/dtype.py`, with the same string aliases
and `set_default_dtype` / `get_default_dtype`. One policy differs on
purpose (ROADMAP C.14): the JAX package runs with x64 off, so its
`canonical()` maps int64 -> int32 and float64 -> float32 at the API
boundary. The port keeps 64-bit widths: torch's `gather`, `scatter` and
`index_select` take int64 indices, and torch keeps int64 as int64
(`framework/flags.py`, `FLAGS_int64_numpy_boundary`). `canonical` is
therefore `convert_dtype` here.
"""
import numpy as np
import torch

__all__ = ["DType", "float16", "bfloat16", "float32", "float64", "int8",
           "int16", "int32", "int64", "uint8", "bool_", "complex64",
           "complex128", "convert_dtype", "canonical", "get_default_dtype",
           "set_default_dtype", "is_floating", "is_inexact", "is_integer",
           "dtype_name"]

DType = torch.dtype

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_STR_ALIASES = {
    "float16": float16, "fp16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int64": int64,
    "uint8": uint8, "bool": bool_,
    "complex64": complex64, "complex128": complex128,
}

_FROM_NUMPY = {np.dtype(k): v for k, v in {
    "float16": float16, "float32": float32, "float64": float64,
    "int8": int8, "int16": int16, "int32": int32, "int64": int64,
    "uint8": uint8, "bool": bool_, "complex64": complex64,
    "complex128": complex128}.items()}

_default_dtype = float32


def set_default_dtype(d):
    global _default_dtype
    _default_dtype = convert_dtype(d)


def get_default_dtype():
    return _default_dtype


def convert_dtype(d):
    """Any dtype spec (str, torch.dtype, numpy dtype or scalar type,
    Python `float` / `int` / `bool`) -> torch.dtype; None stays None."""
    if d is None or isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        key = d.lower()
        if key not in _STR_ALIASES:
            raise ValueError(f"Unknown dtype string: {d!r}")
        return _STR_ALIASES[key]
    if d is float:
        return float64
    if d is int:
        return int64
    if d is bool:
        return bool_
    try:
        nd = np.dtype(d)
    except TypeError:
        raise ValueError(f"Unknown dtype: {d!r}") from None
    if nd.name == "bfloat16":
        return bfloat16
    if nd not in _FROM_NUMPY:
        raise ValueError(f"Unsupported dtype: {d!r}")
    return _FROM_NUMPY[nd]


canonical = convert_dtype


def is_floating(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_inexact(dtype) -> bool:
    d = convert_dtype(dtype)
    return d.is_floating_point or d.is_complex


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d == bool_)


def dtype_name(dtype) -> str:
    return str(convert_dtype(dtype)).replace("torch.", "")

