"""In-place op variants (`paddle.tanh_`, `x.clip_()`, ...), counterpart
of `paddle_tpu/tensor/inplace.py`.

An `op_` computes the out-of-place op and rebinds the tensor's value
(`Tensor._rebind`, tracked): under grad mode the change is recorded like
the op it is, so backward goes through it; a trainable leaf raises, as
in the reference; under no_grad a trainable tensor stays trainable. The
tensor keeps its Python identity, `stop_gradient` and name."""
from ..core.tensor import Tensor, _wrap
from . import extras, manipulation, math as _math

__all__ = []


def _make_inplace(fn, name):
    def inplace(x, *args, **kwargs):
        return x._rebind(lambda d: fn(_wrap(d), *args, **kwargs)._data)
    inplace.__name__ = inplace.__qualname__ = name
    inplace.__doc__ = (f"In-place variant of `{fn.__name__}`: writes the "
                       f"result back into `x` and returns it.")
    return inplace


# (public name, source module, functional name)
_INPLACE_OPS = [
    ("tanh_", _math, "tanh"),
    ("clip_", _math, "clip"),
    ("exp_", _math, "exp"),
    ("sqrt_", _math, "sqrt"),
    ("rsqrt_", _math, "rsqrt"),
    ("reciprocal_", _math, "reciprocal"),
    ("round_", _math, "round"),
    ("floor_", _math, "floor"),
    ("ceil_", _math, "ceil"),
    ("lerp_", _math, "lerp"),
    ("erfinv_", _math, "erfinv"),
    ("remainder_", _math, "remainder"),
    ("mod_", _math, "remainder"),
    ("squeeze_", manipulation, "squeeze"),
    ("unsqueeze_", manipulation, "unsqueeze"),
    ("flatten_", manipulation, "flatten"),
    ("reshape_", manipulation, "reshape"),
    ("scatter_", manipulation, "scatter"),
    ("put_along_axis_", manipulation, "put_along_axis"),
    ("index_add_", extras, "index_add"),
]

for _pub, _mod, _src in _INPLACE_OPS:
    globals()[_pub] = _make_inplace(getattr(_mod, _src), _pub)
    __all__.append(_pub)


def _patch_methods():
    for pub in __all__:
        setattr(Tensor, pub, globals()[pub])


_patch_methods()
