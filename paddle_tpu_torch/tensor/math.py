"""Math ops (counterpart of `paddle_tpu/tensor/math.py`).

Each op is a torch call routed through `apply_op`, so torch's autograd
records it. Where torch and the JAX package's `jnp` calls differ, the
JAX package's behaviour is spelled out: reductions over an axis list,
`mean` / `std` of integers (the default float), `lerp`'s formula,
`outer` of n-d inputs, `imag` of a real tensor, `take`'s modes."""
import operator

import torch

from ..core import dtype as _dt
from ..core.tensor import Tensor, _binop, _wrap, apply_op

__all__ = [
    "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
    "square", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
    "tanh", "asinh", "acosh", "atanh", "abs", "ceil", "floor", "round",
    "trunc", "reciprocal", "sign", "erf", "erfinv", "lgamma", "digamma",
    "neg", "frac", "add", "subtract", "multiply", "divide", "floor_divide",
    "mod", "remainder", "pow", "maximum", "minimum", "fmax", "fmin",
    "atan2", "scale", "clip", "sum", "mean", "max", "min", "amax", "amin",
    "prod", "logsumexp", "cumsum", "cumprod", "isnan", "isinf",
    "isfinite", "all", "any", "add_n", "multiplex", "stanh", "kron",
    "diff", "angle", "conj", "real", "imag", "nan_to_num", "lerp",
    "inner", "outer", "heaviside", "rad2deg", "deg2rad", "gcd", "lcm",
    "take", "broadcast_shape", "increment", "count_nonzero", "numel"]


def _u(fn, name):
    def op(x, *a, **kw):
        kw.pop("name", None)
        return apply_op(fn, x, name=name, **kw)
    op.__name__ = op.__qualname__ = name
    return op


def _tt(fn):
    """`fn` of two torch tensors, taking a Python scalar on either side
    as a 0-d tensor of the other operand's dtype (a host scalar, which
    torch passes to a device kernel by value)."""
    def f(x, y):
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(x, dtype=y.dtype)
        elif not isinstance(y, torch.Tensor):
            y = torch.tensor(y, dtype=x.dtype)
        return fn(x, y)
    f.__name__ = f.__qualname__ = fn.__name__
    return f


exp = _u(torch.exp, "exp")
expm1 = _u(torch.expm1, "expm1")
log = _u(torch.log, "log")
log2 = _u(torch.log2, "log2")
log10 = _u(torch.log10, "log10")
log1p = _u(torch.log1p, "log1p")
sqrt = _u(torch.sqrt, "sqrt")
rsqrt = _u(torch.rsqrt, "rsqrt")
square = _u(torch.square, "square")
sin = _u(torch.sin, "sin")
cos = _u(torch.cos, "cos")
tan = _u(torch.tan, "tan")
asin = _u(torch.asin, "asin")
acos = _u(torch.acos, "acos")
atan = _u(torch.atan, "atan")
sinh = _u(torch.sinh, "sinh")
cosh = _u(torch.cosh, "cosh")
tanh = _u(torch.tanh, "tanh")
asinh = _u(torch.asinh, "asinh")
acosh = _u(torch.acosh, "acosh")
atanh = _u(torch.atanh, "atanh")
abs = _u(torch.abs, "abs")
ceil = _u(torch.ceil, "ceil")
floor = _u(torch.floor, "floor")
round = _u(torch.round, "round")
trunc = _u(torch.trunc, "trunc")
reciprocal = _u(torch.reciprocal, "reciprocal")
sign = _u(torch.sign, "sign")
erf = _u(torch.erf, "erf")
erfinv = _u(torch.erfinv, "erfinv")
lgamma = _u(torch.lgamma, "lgamma")
digamma = _u(torch.digamma, "digamma")
neg = _u(torch.neg, "neg")
frac = _u(torch.frac, "frac")

_maximum = _tt(torch.maximum)
_minimum = _tt(torch.minimum)
_fmax = _tt(torch.fmax)
_fmin = _tt(torch.fmin)
_atan2 = _tt(torch.atan2)
_kron = _tt(torch.kron)
_inner = _tt(torch.inner)
_heaviside = _tt(torch.heaviside)
_gcd = _tt(torch.gcd)
_lcm = _tt(torch.lcm)


def add(x, y, name=None):
    return _binop(operator.add, x, y, "add")


def subtract(x, y, name=None):
    return _binop(operator.sub, x, y, "subtract")


def multiply(x, y, name=None):
    return _binop(operator.mul, x, y, "multiply")


def divide(x, y, name=None):
    return _binop(operator.truediv, x, y, "divide")


def floor_divide(x, y, name=None):
    return _binop(operator.floordiv, x, y, "floor_divide")


def mod(x, y, name=None):
    return _binop(operator.mod, x, y, "mod")


remainder = mod


def pow(x, y, name=None):
    return _binop(operator.pow, x, y, "pow")


def maximum(x, y, name=None):
    return _binop(_maximum, x, y, "maximum")


def minimum(x, y, name=None):
    return _binop(_minimum, x, y, "minimum")


def fmax(x, y, name=None):
    return _binop(_fmax, x, y, "fmax")


def fmin(x, y, name=None):
    return _binop(_fmin, x, y, "fmin")


def atan2(x, y, name=None):
    return _binop(_atan2, x, y, "atan2")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    def fn(a):
        return a * scale + bias if bias_after_scale else (a + bias) * scale
    out = apply_op(fn, x)
    if act:
        act_fn = getattr(torch, act, None) or getattr(torch.nn.functional,
                                                      act)
        out = apply_op(act_fn, out, name=act)
    return out


def clip(x, min=None, max=None, name=None):
    lo = min._data if isinstance(min, Tensor) else min
    hi = max._data if isinstance(max, Tensor) else max
    return apply_op(lambda a: torch.clamp(a, lo, hi), x)


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    if isinstance(axis, Tensor):
        return tuple(int(a) for a in axis.numpy().reshape(-1))
    return int(axis)


def _dims(a, axis):
    """Reduction dims of `a` for a normalised `_axis` value (None: all)."""
    if axis is None:
        return tuple(range(a.dim()))
    return axis if isinstance(axis, tuple) else (axis,)


def _float(a):
    return a if (a.is_floating_point() or a.is_complex()) else \
        a.to(_dt.get_default_dtype())


def _keep_all(out, a, keepdim):
    return out.reshape([1] * a.dim()) if keepdim else out


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    d = _dt.convert_dtype(dtype)
    ax = _axis(axis)

    def fn(a):
        if ax == ():
            return a.to(d) if d is not None else a.clone()
        return torch.sum(a, dim=_dims(a, ax), keepdim=keepdim, dtype=d)
    return apply_op(fn, x)


def mean(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.mean(_float(a), dim=_dims(a, ax),
                                         keepdim=keepdim), x)


def max(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.amax(a, dim=_dims(a, ax),
                                         keepdim=keepdim), x)


def min(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.amin(a, dim=_dims(a, ax),
                                         keepdim=keepdim), x)


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    d = _dt.convert_dtype(dtype)
    ax = _axis(axis)

    def fn(a):
        if ax is None:
            return _keep_all(torch.prod(a, dtype=d), a, keepdim)
        out = a if d is None else a.to(d)
        for dim in sorted((x % a.dim() for x in _dims(a, ax)),
                          reverse=True):
            out = torch.prod(out, dim, keepdim=keepdim)
        return out
    return apply_op(fn, x)


def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)

    def fn(a):
        if ax is None:
            return _keep_all(torch.logsumexp(a.reshape(-1), 0), a, keepdim)
        return torch.logsumexp(a, _dims(a, ax), keepdim=keepdim)
    return apply_op(fn, x)


def cumsum(x, axis=None, dtype=None, name=None):
    d = _dt.convert_dtype(dtype)
    return apply_op(lambda a: torch.cumsum(
        a if axis is not None else a.reshape(-1),
        axis if axis is not None else 0, dtype=d), x)


def cumprod(x, dim=None, dtype=None, name=None):
    d = _dt.convert_dtype(dtype)
    return apply_op(lambda a: torch.cumprod(
        a if dim is not None else a.reshape(-1),
        dim if dim is not None else 0, dtype=d), x)


def isnan(x, name=None):
    return apply_op(torch.isnan, x)


def isinf(x, name=None):
    return apply_op(torch.isinf, x)


def isfinite(x, name=None):
    return apply_op(torch.isfinite, x)


def all(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)

    def fn(a):
        if ax is None:
            return _keep_all(torch.all(a), a, keepdim)
        return torch.all(a, dim=_dims(a, ax), keepdim=keepdim)
    return apply_op(fn, x)


def any(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)

    def fn(a):
        if ax is None:
            return _keep_all(torch.any(a), a, keepdim)
        return torch.any(a, dim=_dims(a, ax), keepdim=keepdim)
    return apply_op(fn, x)


def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        return inputs

    def fn(*xs):
        out = xs[0]
        for v in xs[1:]:
            out = out + v
        return out
    return apply_op(fn, *inputs)


def multiplex(inputs, index, name=None):
    def fn(idx, *xs):
        stacked = torch.stack(xs, 0)
        sel = idx.reshape(-1).long()
        return stacked[sel, torch.arange(stacked.shape[1],
                                         device=stacked.device)]
    return apply_op(fn, index, *inputs)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply_op(lambda a: scale_b * torch.tanh(scale_a * a), x)


def kron(x, y, name=None):
    return _binop(_kron, x, y, "kron")


def diff(x, n=1, axis=-1, name=None):
    return apply_op(lambda a: torch.diff(a, n, axis), x)


def angle(x, name=None):
    return apply_op(lambda a: torch.angle(_float(a)), x)


def conj(x, name=None):
    return apply_op(torch.conj_physical, x)


def real(x, name=None):
    return apply_op(lambda a: torch.real(a).clone(), x)


def imag(x, name=None):
    return apply_op(lambda a: torch.imag(a).clone() if a.is_complex()
                    else torch.zeros_like(a), x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply_op(lambda a: torch.nan_to_num(a, nan, posinf, neginf), x)


def lerp(x, y, weight, name=None):
    """x + weight * (y - x), the JAX package's formula."""
    if isinstance(weight, Tensor):
        return apply_op(lambda a, b, w: a + w * (b - a), x, y, weight)
    return apply_op(lambda a, b: a + weight * (b - a), x, y)


def inner(x, y, name=None):
    return _binop(_inner, x, y, "inner")


def outer(x, y, name=None):
    return apply_op(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)),
                    x, y)


def heaviside(x, y, name=None):
    return _binop(_heaviside, x, y, "heaviside")


def rad2deg(x, name=None):
    return apply_op(lambda a: torch.rad2deg(_float(a)), x)


def deg2rad(x, name=None):
    return apply_op(lambda a: torch.deg2rad(_float(a)), x)


def gcd(x, y, name=None):
    return _binop(_gcd, x, y, "gcd")


def lcm(x, y, name=None):
    return _binop(_lcm, x, y, "lcm")


def take(x, index, mode="raise", name=None):
    """Output has INDEX's shape; 'raise' takes negative indices as
    idx + numel and checks the bounds eagerly, 'wrap' takes the
    remainder, 'clip' clamps to [0, numel-1]."""
    if mode not in ("raise", "wrap", "clip"):
        raise ValueError(
            f"'mode' in 'take' should be 'raise', 'wrap', 'clip', but "
            f"received {mode}.")
    if mode == "raise":
        n = x.size
        iv = index._data
        if iv.numel() and (int(iv.min()) < -n or int(iv.max()) >= n):
            raise ValueError(
                f"(InvalidArgument) take: index out of range for input "
                f"with {n} elements (valid range [-{n}, {n}), got min "
                f"{int(iv.min())} max {int(iv.max())}).")

    def fn(a, i):
        flat = a.reshape(-1)
        n = flat.shape[0]
        idx = i.long()
        if mode == "raise":
            idx = torch.where(idx < 0, idx + n, idx)
        elif mode == "wrap":
            idx = torch.remainder(idx, n)
        else:
            idx = idx.clamp(0, n - 1)
        return flat[idx.reshape(-1)].reshape(i.shape)
    return apply_op(fn, x, index)


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def increment(x, value=1.0, name=None):
    return x._rebind(lambda d: d + value, tracked=False)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)

    def fn(a):
        dims = _dims(a, ax)
        out = torch.count_nonzero(a, dim=dims)
        if keepdim:
            shape = [1 if d in {v % a.dim() for v in dims} else s
                     for d, s in enumerate(a.shape)]
            out = out.reshape(shape)
        return out
    return apply_op(fn, x)


def numel(x, name=None):
    return _wrap(torch.tensor(x.size, dtype=torch.int64,
                              device=x._data.device))

