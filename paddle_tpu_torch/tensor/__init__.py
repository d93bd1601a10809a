"""paddle.tensor for the port: the functional tensor-op surface.

Counterpart of `paddle_tpu/tensor/__init__.py`. It also patches the op
set onto `core.Tensor` as methods, as the reference patches its python
ops onto the C tensor type."""
import types as _types

from ..core.tensor import Tensor
from . import (creation, einsum as _einsum_mod, extras, linalg, logic,
               manipulation, math, random, search, stat)

from .creation import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from .einsum import einsum  # noqa: F401

_METHOD_MODULES = [math, manipulation, linalg, logic, search, stat, creation,
                   extras]

# names that must not become Tensor methods (creation ops, helpers)
_SKIP = {
    "zeros", "ones", "full", "empty", "arange", "linspace", "logspace", "eye",
    "meshgrid", "to_tensor", "assign", "scatter_nd", "broadcast_shape",
    "is_tensor", "tril_indices", "triu_indices", "gaussian", "finfo",
    "iinfo",
}


def _patch_tensor_methods():
    for mod in _METHOD_MODULES:
        for name in mod.__all__:
            if name in _SKIP:
                continue
            fn = getattr(mod, name)
            if callable(fn) and not isinstance(fn, type) \
                    and not hasattr(Tensor, name):
                setattr(Tensor, name, fn)
    Tensor.abs_ = Tensor.abs            # not truly in place, as in the reference
    Tensor.cast_ = extras._cast_


_patch_tensor_methods()

from .inplace import *  # noqa: F401,F403,E402

# Export ops (and Tensor) only, never the submodules: a star import at
# the package's top level would otherwise shadow same-named modules
# there (linalg, random, math, search).
__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_") and not isinstance(_v, _types.ModuleType)]
