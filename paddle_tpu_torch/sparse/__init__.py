"""paddle.sparse of the port (counterpart of `paddle_tpu/sparse/`).

`SparseCooTensor` and `SparseCsrTensor` are the reference's own classes,
(indices, values, shape) over the port's Tensors. Value ops act on the
stored values only (recorded by autograd through `apply_op`); binary ops
and `matmul` densify, as in the reference; `coalesce` and the COO/CSR
conversions are host numpy, as there. The point-cloud convolutions are in
`sparse/nn/conv.py`.
"""
import numpy as np
import torch

from ..core import dtype as _dt
from ..core.tensor import Tensor, apply_op, to_tensor
from . import nn  # noqa: F401

__all__ = ["SparseCooTensor", "SparseCsrTensor", "sparse_coo_tensor",
           "sparse_csr_tensor", "is_same_shape", "matmul", "masked_matmul",
           "add", "subtract", "multiply", "divide", "relu", "tanh", "sin",
           "sinh", "asin", "asinh", "atan", "atanh", "sqrt", "square",
           "abs", "pow", "neg", "cast", "transpose", "coalesce", "nn",
           "mv", "addmm", "reshape", "to_sparse_coo"]


def _host(t):
    d = t._data if isinstance(t, Tensor) else t
    if isinstance(d, torch.Tensor):
        return d.detach().cpu().numpy()
    return np.asarray(d)


def _as_tensor(v, like=None):
    if isinstance(v, Tensor):
        return v
    if isinstance(v, torch.Tensor):
        return Tensor(v)
    place = like._data.device if isinstance(like, Tensor) else None
    return to_tensor(np.asarray(v), place=place)


class SparseCooTensor:
    def __init__(self, indices, values, shape):
        self.values_ = _as_tensor(values)
        self.indices_ = _as_tensor(indices, self.values_)
        self.shape = list(shape)

    @property
    def dtype(self):
        return self.values_.dtype

    @property
    def place(self):
        return self.values_.place

    def nnz(self):
        return int(self.values_._data.shape[0])

    def indices(self):
        return self.indices_

    def values(self):
        return self.values_

    def to_dense(self):
        idx = self.indices_._data
        shape = tuple(self.shape)

        def fn(v):
            out = v.new_zeros(shape)
            ii = tuple(idx[i].to(v.device).long() for i in range(idx.shape[0]))
            return out.index_put(ii, v, accumulate=True)
        return apply_op(fn, self.values_, name="sparse_to_dense")

    def to_sparse_csr(self):
        """2-D only; entries are sorted by (row, col)."""
        ind = _host(self.indices_)
        order = np.lexsort((ind[1], ind[0]))
        rows, cols = ind[0][order], ind[1][order]
        o = torch.as_tensor(order, device=self.values_._data.device)
        vals = apply_op(lambda v: v[o], self.values_)
        crows = np.zeros(self.shape[0] + 1, np.int64)
        np.add.at(crows, rows + 1, 1)
        crows = np.cumsum(crows)
        return SparseCsrTensor(_as_tensor(crows, vals),
                               _as_tensor(cols, vals), vals, self.shape)

    def is_sparse_coo(self):
        return True

    def is_sparse_csr(self):
        return False

    def __repr__(self):
        return (f"SparseCooTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={self.values_._data.dtype})")


class SparseCsrTensor:
    def __init__(self, crows, cols, values, shape):
        self.values_ = _as_tensor(values)
        self.crows_ = _as_tensor(crows, self.values_)
        self.cols_ = _as_tensor(cols, self.values_)
        self.shape = list(shape)

    @property
    def dtype(self):
        return self.values_.dtype

    def crows(self):
        return self.crows_

    def cols(self):
        return self.cols_

    def values(self):
        return self.values_

    def nnz(self):
        return int(self.values_._data.shape[0])

    def to_sparse_coo(self, sparse_dim=2):
        crows = _host(self.crows_)
        rows = np.repeat(np.arange(len(crows) - 1), np.diff(crows))
        dev = self.cols_._data.device
        indices = torch.stack([torch.as_tensor(rows, device=dev),
                               self.cols_._data.to(torch.int64)])
        return SparseCooTensor(Tensor(indices), self.values_, self.shape)

    def to_dense(self):
        return self.to_sparse_coo().to_dense()

    def is_sparse_coo(self):
        return False

    def is_sparse_csr(self):
        return True

    def __repr__(self):
        return (f"SparseCsrTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={self.values_._data.dtype})")


def _values(v, dtype, place):
    t = v if isinstance(v, Tensor) else to_tensor(np.asarray(v), place=place)
    if dtype is not None:
        t = t.astype(dtype)
    return t


def sparse_coo_tensor(indices, values, shape=None, dtype=None, place=None,
                      stop_gradient=True):
    val = _values(values, dtype, place)
    ind = _as_tensor(indices, val)
    if shape is None:
        shape = [int(d) + 1 for d in _host(ind).max(axis=1)]
    if not stop_gradient:
        val.stop_gradient = False
    return SparseCooTensor(ind, val, shape)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None, place=None,
                      stop_gradient=True):
    val = _values(values, dtype, place)
    if not stop_gradient:
        val.stop_gradient = False
    return SparseCsrTensor(crows, cols, val, shape)


def coalesce(x):
    """Merge duplicate coordinates (summing their values) and sort them
    row-major (host numpy, as the reference)."""
    ind = _host(x.indices_)
    vals = _host(x.values_)
    flat = np.ravel_multi_index(tuple(ind), tuple(x.shape[:ind.shape[0]]))
    uniq, inv = np.unique(flat, return_inverse=True)
    merged = np.zeros((uniq.size,) + vals.shape[1:], vals.dtype)
    np.add.at(merged, inv, vals)
    new_ind = np.stack(np.unravel_index(uniq, tuple(x.shape[:ind.shape[0]])))
    return SparseCooTensor(_as_tensor(new_ind, x.values_),
                           _as_tensor(merged, x.values_), x.shape)


def is_same_shape(x, y):
    return list(x.shape) == list(y.shape)


def _values_op(fn, name="sparse_values"):
    def op(x, *a, name=None, **kw):
        def on(t):
            return apply_op(lambda v: fn(v, *a, **kw), t, name=op.__name__)
        if isinstance(x, SparseCooTensor):
            return SparseCooTensor(x.indices_, on(x.values_), x.shape)
        if isinstance(x, SparseCsrTensor):
            return SparseCsrTensor(x.crows_, x.cols_, on(x.values_),
                                   x.shape)
        return on(x)
    op.__name__ = name
    return op


# the zero-preserving elementwise family: values only
relu = _values_op(torch.relu, "relu")
tanh = _values_op(torch.tanh, "tanh")
sin = _values_op(torch.sin, "sin")
sinh = _values_op(torch.sinh, "sinh")
asin = _values_op(torch.asin, "asin")
asinh = _values_op(torch.asinh, "asinh")
atan = _values_op(torch.atan, "atan")
atanh = _values_op(torch.atanh, "atanh")
sqrt = _values_op(torch.sqrt, "sqrt")
square = _values_op(torch.square, "square")
abs = _values_op(torch.abs, "abs")          # noqa: A001
neg = _values_op(torch.neg, "neg")
pow = _values_op(torch.pow, "pow")          # noqa: A001
tan = _values_op(torch.tan, "tan")
log1p = _values_op(torch.log1p, "log1p")
expm1 = _values_op(torch.expm1, "expm1")
deg2rad = _values_op(torch.deg2rad, "deg2rad")
rad2deg = _values_op(torch.rad2deg, "rad2deg")


def cast(x, index_dtype=None, value_dtype=None):
    vd = _dt.convert_dtype(value_dtype) if value_dtype else None
    idd = _dt.convert_dtype(index_dtype) if index_dtype else None

    def c(t, d):
        return t if d is None else t.astype(d)
    if isinstance(x, SparseCooTensor):
        return SparseCooTensor(c(x.indices_, idd), c(x.values_, vd), x.shape)
    return SparseCsrTensor(c(x.crows_, idd), c(x.cols_, idd),
                           c(x.values_, vd), x.shape)


def transpose(x, perm, name=None):
    if isinstance(x, SparseCooTensor):
        ind = Tensor(x.indices_._data[list(perm)])
        shape = [x.shape[p] for p in perm]
        return SparseCooTensor(ind, x.values_, shape)
    return transpose(x.to_sparse_coo(), perm).to_sparse_csr()


def _dense(x):
    """x as a dense Tensor."""
    if isinstance(x, (SparseCooTensor, SparseCsrTensor)):
        return x.to_dense()
    return _as_tensor(x)


def matmul(x, y, name=None):
    """x @ y, densified (as the reference)."""
    return apply_op(torch.matmul, _dense(x), _dense(y), name="sparse_matmul")


def masked_matmul(x, y, mask, name=None):
    """dense @ dense computed only at the mask's stored positions."""
    coo = mask if isinstance(mask, SparseCooTensor) else \
        mask.to_sparse_coo()
    ind = coo.indices_._data

    def fn(xd, yd):
        rows, cols = ind[0].to(xd.device), ind[1].to(xd.device)
        return torch.einsum("nk,nk->n", xd[rows, :], yd[:, cols].T)
    vals = apply_op(fn, _dense(x), _dense(y), name="masked_matmul")
    out = SparseCooTensor(coo.indices_, vals, mask.shape)
    return out if isinstance(mask, SparseCooTensor) else out.to_sparse_csr()


def _from_dense_coo(t):
    arr = _host(t)
    ind = np.stack(np.nonzero(arr))
    idx = torch.as_tensor(ind, device=t._data.device)
    vals = apply_op(lambda d: d[tuple(idx)], t)
    return SparseCooTensor(Tensor(idx), vals, list(arr.shape))


def _binary(fn, name):
    def op(x, y, name=None):
        out = apply_op(fn, _dense(x), _dense(y), name=op.__name__)
        if isinstance(x, SparseCooTensor) and isinstance(y, SparseCooTensor):
            return _from_dense_coo(out)
        if isinstance(x, SparseCsrTensor) and isinstance(y, SparseCsrTensor):
            return _from_dense_coo(out).to_sparse_csr()
        return out
    op.__name__ = name
    return op


add = _binary(torch.add, "sparse_add")
subtract = _binary(torch.sub, "sparse_subtract")
multiply = _binary(torch.mul, "sparse_multiply")
divide = _binary(torch.div, "sparse_divide")


def to_sparse_coo(dense, sparse_dim=None):
    """A dense Tensor's nonzeros as a SparseCooTensor."""
    return _from_dense_coo(dense)


def mv(x, vec, name=None):
    """sparse matrix @ dense vector."""
    return apply_op(torch.matmul, _dense(x), _as_tensor(vec), name="sparse_mv")


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """beta * input + alpha * (x @ y), x sparse."""
    return apply_op(lambda i, a, b: beta * i + alpha * (a @ b),
                    _dense(input), _dense(x), _dense(y), name="sparse_addmm")


def reshape(x, shape, name=None):
    """Reshape a COO tensor: linearize its indices and split them again
    under the new shape."""
    if isinstance(x, SparseCsrTensor):
        x = x.to_sparse_coo(2)
    old_shape = x.shape
    new_shape = list(shape)
    n_el = int(np.prod(old_shape))
    if -1 in new_shape:
        i = new_shape.index(-1)
        new_shape[i] = n_el // int(-np.prod([d for d in new_shape]))
    idx = x.indices_._data
    strides = np.cumprod([1] + list(old_shape[::-1]))[:-1][::-1].copy()
    flat = (idx * torch.as_tensor(strides, device=idx.device)[:, None]).sum(0)
    new_strides = np.cumprod([1] + list(new_shape[::-1]))[:-1][::-1].copy()
    new_idx = []
    rem = flat
    for st in new_strides:
        new_idx.append(torch.div(rem, int(st), rounding_mode="floor"))
        rem = rem % int(st)
    return SparseCooTensor(Tensor(torch.stack(new_idx).to(idx.dtype)),
                           x.values_, new_shape)
