"""The remaining tensor ops of the JAX package's op-breadth batch
(counterpart of `paddle_tpu/tensor/extras.py`): linalg-ish, elementwise,
index and shape ops, numeric helpers, `finfo` / `iinfo`, `gaussian`,
`fill_diagonal_` and the untracked `cast_` (the one `op_` variant of
the reference's batch that `inplace.py` does not replace)."""
import numpy as np
import torch

from ..core import dtype as _dt
from ..core.device import current_device
from ..core.random import generator
from ..core.tensor import Tensor, _wrap, apply_op
from .creation import _shape
from .search import _quantile

__all__ = [
    "addmm", "trace", "diagonal", "vector_norm", "renorm", "lu_unpack",
    "logit", "sgn", "logcumsumexp", "nanquantile", "cast", "bucketize",
    "index_add", "crop", "unstack", "tril_indices", "triu_indices",
    "fill_diagonal_tensor", "rank", "fill", "zero_", "fill_diagonal_",
    "vander", "trapezoid", "cumulative_trapezoid", "frexp", "ldexp",
    "copysign", "nextafter", "hypot", "signbit", "isposinf", "isneginf",
    "isreal", "polar", "view_as_complex", "view_as_real", "finfo", "iinfo",
    "matrix_exp", "cdist", "householder_product", "cond", "frobenius_norm",
    "is_complex", "is_floating_point", "is_integer", "gaussian", "shape"]


# ------------------------------------------------------------ linalg-ish

def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply_op(lambda i, a, b: beta * i + alpha * (a @ b), input, x, y)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(lambda a: torch.diagonal(a, offset, axis1, axis2)
                    .sum(-1), x)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(lambda a: torch.diagonal(a, offset, axis1, axis2), x)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    def fn(a):
        if axis is None:
            return torch.linalg.vector_norm(a.reshape(-1), p, 0,
                                            keepdim=keepdim)
        return torch.linalg.vector_norm(a, p, axis, keepdim=keepdim)
    return apply_op(fn, x)


def renorm(x, p, axis, max_norm, name=None):
    """Per-slice p-norm clamp along `axis`."""
    def fn(a):
        moved = torch.movedim(a, axis, 0)
        flat = moved.reshape(moved.shape[0], -1)
        norms = torch.linalg.vector_norm(flat, p, 1)
        scale_ = torch.where(norms > max_norm,
                             max_norm / torch.clamp_min(norms, 1e-12), 1.0)
        return torch.movedim((flat * scale_[:, None]).reshape(moved.shape),
                             0, axis)
    return apply_op(fn, x)


def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True,
              name=None):
    """(P, L, U) of a packed LU factorization, A = P @ L @ U."""
    return apply_op(lambda a, piv: tuple(torch.lu_unpack(a, piv)),
                    lu_data, lu_pivots)


# ----------------------------------------------------------- elementwise

def logit(x, eps=None, name=None):
    def fn(a):
        if eps is not None:
            a = torch.clamp(a, eps, 1.0 - eps)
        return torch.log(a / (1.0 - a))
    return apply_op(fn, x)


def sgn(x, name=None):
    return apply_op(torch.sgn, x, name="sgn")


def logcumsumexp(x, axis=None, dtype=None, name=None):
    return apply_op(lambda a: torch.logcumsumexp(
        a.reshape(-1) if axis is None else a, 0 if axis is None else axis),
        x)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile("nanquantile", x, q, axis, keepdim)


def cast(x, dtype):
    return x.astype(dtype)


# --------------------------------------------------------- index/shape ops

def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return apply_op(lambda a, s: torch.bucketize(a, s, out_int32=out_int32,
                                                 right=right),
                    x, sorted_sequence)


def index_add(x, index, axis, value, name=None):
    return apply_op(lambda a, i, v: torch.index_add(a, axis, i.long(),
                                                    v.to(a.dtype)),
                    x, index, value)


def crop(x, shape=None, offsets=None, name=None):
    def fn(a):
        shp = [int(s) for s in np.asarray(shape).tolist()] \
            if shape is not None else list(a.shape)
        offs = [int(o) for o in np.asarray(offsets).tolist()] \
            if offsets is not None else [0] * a.dim()
        shp = [a.shape[i] - offs[i] if s == -1 else s
               for i, s in enumerate(shp)]
        return a[tuple(slice(o, o + s) for o, s in zip(offs, shp))]
    return apply_op(fn, x)


def unstack(x, axis=0, num=None, name=None):
    return list(apply_op(lambda a: torch.unbind(a, axis), x))


def _indices(fn, row, col, offset, dtype):
    from ..core.device import current_device
    col = row if col is None else col
    return _wrap(fn(row, col, offset, device=current_device(),
                    dtype=_dt.convert_dtype(dtype)))


def tril_indices(row, col=None, offset=0, dtype="int64", name=None):
    return _indices(torch.tril_indices, row, col, offset, dtype)


def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    return _indices(torch.triu_indices, row, col, offset, dtype)


def _diag_positions(m, n, offset, device):
    i0, j0 = (0, offset) if offset >= 0 else (-offset, 0)
    k = max(min(m - i0, n - j0), 0)
    ar = torch.arange(k, device=device)
    return i0 + ar, j0 + ar, k


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    def fn(a, v):
        moved = torch.movedim(a, (dim1, dim2), (-2, -1))
        ii, jj, k = _diag_positions(moved.shape[-2], moved.shape[-1],
                                    offset, a.device)
        vb = torch.broadcast_to(v, moved.shape[:-2] + (k,)).to(a.dtype)
        upd = moved.clone()
        upd[..., ii, jj] = vb
        return torch.movedim(upd, (-2, -1), (dim1, dim2))
    return apply_op(fn, x, y)


def rank(input, name=None):
    nd = input.ndim if hasattr(input, "ndim") else np.ndim(input)
    dev = input._data.device if isinstance(input, Tensor) else None
    return _wrap(torch.tensor(nd, dtype=torch.int32, device=dev))


# ------------------------------------------------------------- inplace ops

def fill(x, value, name=None):
    return apply_op(lambda a: torch.full_like(a, value), x)


def zero_(x):
    return x.zero_()


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    if wrap:
        raise NotImplementedError("fill_diagonal_: wrap=True is not "
                                  "supported")

    def fn(a):
        ii, jj, k = _diag_positions(a.shape[-2], a.shape[-1], offset,
                                    a.device)
        if k <= 0:
            return a
        out = a.clone()
        out[..., ii, jj] = value
        return out
    return x._rebind(fn, tracked=False)


def _cast_(x, dtype):
    """x.cast_(dtype): the reference's untracked in-place cast."""
    d = _dt.convert_dtype(dtype)
    return x._rebind(lambda a: a.to(d), tracked=False)


# ----------------------------------------------- numeric helpers

def vander(x, n=None, increasing=False, name=None):
    def fn(a):
        cols = a.shape[-1] if n is None else n
        exps = torch.arange(cols, device=a.device)
        if not increasing:
            exps = exps.flip(0)
        return torch.pow(a.unsqueeze(-1), exps)
    return apply_op(fn, x)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is None:
        return apply_op(lambda yv: torch.trapezoid(
            yv, dx=1.0 if dx is None else dx, dim=axis), y)
    return apply_op(lambda yv, xv: torch.trapezoid(yv, xv, dim=axis), y, x)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """Cumulative trapezoid along axis, without the initial zero."""
    def fn(yv, *rest):
        yv = torch.movedim(yv, axis, -1)
        if rest:
            xv = torch.broadcast_to(torch.movedim(rest[0], axis, -1),
                                    yv.shape)
            d = torch.diff(xv, dim=-1)
        else:
            d = 1.0 if dx is None else dx
        avg = (yv[..., 1:] + yv[..., :-1]) / 2.0
        return torch.movedim(torch.cumsum(avg * d, -1), -1, axis)
    return apply_op(fn, y) if x is None else apply_op(fn, y, x)


def frexp(x, name=None):
    return apply_op(lambda a: tuple(torch.frexp(a)), x)


def ldexp(x, y, name=None):
    return apply_op(lambda a, b: a * torch.pow(2.0, b.to(a.dtype)), x, y)


def copysign(x, y, name=None):
    return apply_op(torch.copysign, x, y, name="copysign")


def nextafter(x, y, name=None):
    return apply_op(torch.nextafter, x, y, name="nextafter")


def hypot(x, y, name=None):
    return apply_op(torch.hypot, x, y, name="hypot")


def signbit(x, name=None):
    return apply_op(torch.signbit, x, name="signbit")


def isposinf(x, name=None):
    return apply_op(torch.isposinf, x, name="isposinf")


def isneginf(x, name=None):
    return apply_op(torch.isneginf, x, name="isneginf")


def isreal(x, name=None):
    return apply_op(torch.isreal, x, name="isreal")


def polar(abs, angle, name=None):
    return apply_op(lambda r, t: torch.polar(r.float(), t.float()),
                    abs, angle)


def view_as_complex(x, name=None):
    return apply_op(lambda a: torch.complex(a[..., 0], a[..., 1]), x)


def view_as_real(x, name=None):
    return apply_op(lambda a: torch.stack([torch.real(a), torch.imag(a)],
                                          -1), x)


class _FInfo:
    def __init__(self, dtype):
        i = torch.finfo(dtype)
        self.min, self.max, self.eps, self.tiny = i.min, i.max, i.eps, i.tiny
        self.bits = i.bits
        self.dtype = _dt.dtype_name(dtype)
        self.smallest_normal = i.smallest_normal
        self.resolution = float(i.resolution)


class _IInfo:
    def __init__(self, dtype):
        i = torch.iinfo(dtype)
        self.min, self.max, self.bits = i.min, i.max, i.bits
        self.dtype = _dt.dtype_name(dtype)


def finfo(dtype):
    return _FInfo(_dt.convert_dtype(dtype))


def iinfo(dtype):
    return _IInfo(_dt.convert_dtype(dtype))


# -------------------------------------------------- linalg stragglers

def matrix_exp(x, name=None):
    return apply_op(torch.linalg.matrix_exp, x, name="matrix_exp")


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Pairwise p-distance between row sets; p=2 through the Gram matrix
    (one product), as the JAX package does."""
    def fn(a, b):
        if p == 2.0:
            a2 = torch.sum(a * a, -1)[..., :, None]
            b2 = torch.sum(b * b, -1)[..., None, :]
            ab = a @ b.transpose(-1, -2)
            return torch.sqrt(torch.clamp_min(a2 + b2 - 2 * ab, 0.0))
        d = torch.abs(a[..., :, None, :] - b[..., None, :, :])
        if p == 0.0:
            return torch.sum((d > 0).to(a.dtype), -1)
        if p == float("inf"):
            return torch.amax(d, -1)
        return torch.sum(d ** p, -1) ** (1.0 / p)
    return apply_op(fn, x, y)


def householder_product(x, tau, name=None):
    """Q from Householder reflectors (LAPACK orgqr)."""
    return apply_op(torch.linalg.householder_product, x, tau,
                    name="householder_product")


def cond(x, p=None, name=None):
    return apply_op(lambda a: torch.linalg.cond(a, p), x)


def frobenius_norm(x, axis=None, keepdim=False, name=None):
    def fn(a):
        sq = torch.abs(a) ** 2
        if axis is None:
            return torch.sqrt(torch.sum(sq))
        ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
        return torch.sqrt(torch.sum(sq, ax, keepdim=keepdim))
    return apply_op(fn, x)


def _dtype_of(x):
    return x._data.dtype if isinstance(x, Tensor) else torch.as_tensor(x).dtype


def is_complex(x):
    return _dtype_of(x).is_complex


def is_floating_point(x):
    return _dtype_of(x).is_floating_point


def is_integer(x):
    return _dt.is_integer(_dtype_of(x))


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    """A normal draw; a nonzero `seed` draws from its own generator (the
    same result for the same seed), seed 0 from the global stream."""
    from ..core.device import current_device
    d = _dt.convert_dtype(dtype) if dtype else torch.float32
    dev = current_device()
    if seed:
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
    else:
        g = generator(dev)
    z = torch.randn(_shape(shape), dtype=d, device=dev, generator=g)
    return _wrap(mean + std * z)


def shape(input, name=None):
    """Shape as an int32 tensor (reference tensor/attribute.py shape)."""
    if isinstance(input, Tensor):
        return _wrap(torch.tensor(input.shape, dtype=torch.int32,
                                  device=input._data.device))
    return _wrap(torch.tensor(np.shape(input), dtype=torch.int32,
                              device=current_device()))
