"""`save` / `load` of nested objects holding tensors.

Counterpart of `paddle_tpu/framework/io.py`, in its file format: a pickle
(protocol 4 by default) in which every tensor travels as a
`_TensorPayload` whose state is `{"dtype": name, "data": numpy array}`,
bfloat16 as float32 data under the name "bfloat16" (exact). Plain numpy
arrays, strings, numbers and containers pickle as they are. A file
either package writes loads in the other:

  * reading, the JAX files name `paddle_tpu.framework.io._TensorPayload`
    and numpy's `multiarray` module as `numpy._core` (numpy 2) or
    `numpy.core` (numpy 1). `_Unpickler.find_class` maps the first to
    this module's class, without importing `paddle_tpu`, and either
    numpy name to the one this numpy has;
  * writing, the payload's class is written under the JAX module's name,
    so the JAX `load` finds its own class. Pickle checks a class
    reference by importing its module; `_Pickler` writes this one
    reference itself and never imports `paddle_tpu`.

`load(..., device="cuda")` puts tensors on the card and raises without
CUDA unless `device="cpu"`; `return_numpy=True` gives numpy arrays
instead (bfloat16 as its exact float32 values: numpy has no bfloat16).
"""
import io
import os
import pickle

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["save", "load", "dumps", "loads"]

# where the JAX package's payload class lives: the name written into and
# read out of every file
_JAX_MODULE = "paddle_tpu.framework.io"
_PAYLOAD = "_TensorPayload"
_NUMPY_CORE = "numpy._core" if hasattr(np, "_core") else "numpy.core"


class _TensorPayload:
    """A tensor as pickled: `dtype` (a numpy dtype name, or "bfloat16")
    and `data` (a host numpy array; float32 for bfloat16). The attributes
    are set in the JAX class's order, so the pickled state is the same."""

    def __init__(self, tensor):
        t = tensor.detach()
        if t.dtype == torch.bfloat16:
            self.dtype = "bfloat16"
            self.data = t.to(torch.float32).cpu().numpy()
        else:
            data = t.cpu().numpy()
            self.dtype = str(data.dtype)
            self.data = data

    def to_tensor(self, device):
        # ascontiguousarray makes a 0-d array 1-d: keep the shape
        a = np.asarray(self.data)
        t = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
        if self.dtype == "bfloat16":
            t = t.to(torch.bfloat16)
        return t.to(device)

    def to_numpy(self):
        return np.asarray(self.data)


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing `_TensorPayload` under the JAX
    module's name without importing it (pickle's own `save_global`
    imports the module to check the reference)."""

    def save_global(self, obj, name=None):
        if obj is not _TensorPayload:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save(_JAX_MODULE)
            self.save(_PAYLOAD)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{_JAX_MODULE}\n{_PAYLOAD}\n"
                       .encode("utf-8"))
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    """Maps the JAX payload class to this module's, and numpy's
    `multiarray` module to the name this numpy gives it."""

    def find_class(self, module, name):
        if (module, name) == (_JAX_MODULE, _PAYLOAD):
            return _TensorPayload
        for old in ("numpy._core", "numpy.core"):
            if module == old or module.startswith(old + "."):
                module = _NUMPY_CORE + module[len(old):]
                break
        return super().find_class(module, name)


def _encode(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_encode(v) for v in obj)
    return obj


def _decode(obj, return_numpy, device):
    if isinstance(obj, _TensorPayload):
        return obj.to_numpy() if return_numpy else obj.to_tensor(device)
    if isinstance(obj, dict):
        return {k: _decode(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_decode(v, return_numpy, device) for v in obj)
    return obj


def dumps(obj, protocol=4):
    """The bytes `save` writes for `obj`."""
    buf = io.BytesIO()
    _Pickler(buf, protocol=protocol).dump(_encode(obj))
    return buf.getvalue()


def loads(data, return_numpy=False, device="cuda"):
    """`load` from bytes."""
    dev = None if return_numpy else resolve_device(device)
    return _decode(_Unpickler(io.BytesIO(data)).load(), return_numpy, dev)


def save(obj, path, protocol=4, **configs):
    """Pickle `obj` to `path` (its directory made as needed), tensors as
    payloads the JAX `framework.io.load` reads."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(dumps(obj, protocol=protocol))


def load(path, return_numpy=False, device="cuda", **configs):
    """Read a file `save` (or the JAX package's `save`) wrote: tensors on
    `device`, or numpy arrays with `return_numpy=True`."""
    with open(path, "rb") as f:
        return loads(f.read(), return_numpy=return_numpy, device=device)
