"""Search and sort ops (counterpart of `paddle_tpu/tensor/search.py`).

The JAX package's tie and order rules are kept explicitly, since torch's
differ and its CUDA kernels promise no order among ties:
  * argsort(descending=True) flips a stable ascending sort, so tied
    elements come out last index first;
  * topk follows `lax.top_k`: ties come out lower index first (a stable
    sort, then the first k);
  * mode takes the smallest modal value and its last occurrence;
  * median averages the two middle values, returns shape [1] for
    axis=None, and is NaN for any NaN or +-inf in the slice;
  * argmax / argmin return the first index among ties (torch's rule)."""
import torch

from ..core import dtype as _dt
from ..core.tensor import Tensor, _wrap, apply_op, to_tensor

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "where",
           "nonzero", "masked_fill", "index_put", "searchsorted",
           "kthvalue", "mode", "median", "nanmedian", "quantile"]


def _arg(reduce, x, axis, keepdim, dtype):
    d = _dt.convert_dtype(dtype or "int64")

    def fn(a):
        if axis is None:
            return reduce(a.reshape(-1), 0).to(d)
        return reduce(a, axis, keepdim=keepdim).to(d)
    return apply_op(fn, x)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, name=None):
    def fn(a):
        idx = torch.argsort(a, dim=axis, stable=True)
        return torch.flip(idx, (axis,)) if descending else idx
    return apply_op(fn, x)


def sort(x, axis=-1, descending=False, name=None):
    def fn(a):
        out = torch.sort(a, dim=axis, stable=True).values
        return torch.flip(out, (axis,)) if descending else out
    return apply_op(fn, x)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    k = int(k._data) if isinstance(k, Tensor) else int(k)

    def fn(a):
        ax = axis if axis is not None else a.dim() - 1
        idx = torch.sort(a, dim=ax, descending=largest,
                         stable=True).indices.narrow(ax, 0, k)
        return torch.take_along_dim(a, idx, ax), idx
    return apply_op(fn, x)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=False)
    return apply_op(lambda c, a, b: torch.where(c.bool(), a, b),
                    condition, x, y)


def nonzero(x, as_tuple=False):
    def fn(a):
        nz = torch.nonzero(a)
        if as_tuple:
            return tuple(nz[:, i:i + 1] for i in range(nz.shape[1]))
        return nz
    return apply_op(fn, x)


def masked_fill(x, mask, value, name=None):
    if isinstance(value, Tensor):
        return apply_op(lambda a, m, v: torch.where(m.bool(), v.to(a.dtype),
                                                    a), x, mask, value)
    return apply_op(lambda a, m: torch.where(m.bool(), value, a).to(a.dtype),
                    x, mask)


def index_put(x, indices, value, accumulate=False, name=None):
    idx = tuple(i._data if isinstance(i, Tensor) else i for i in indices)
    if not isinstance(value, Tensor):
        value = to_tensor(value, dtype=x.dtype, place=x.place)
    return apply_op(lambda a, v: a.index_put(idx, v.to(a.dtype),
                                             accumulate=accumulate),
                    x, value)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return apply_op(lambda s, v: torch.searchsorted(
        s, v, out_int32=out_int32, right=right), sorted_sequence, values)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def fn(a):
        srt = torch.sort(a, dim=axis, stable=True)
        vals = srt.values.select(axis, k - 1)
        inds = srt.indices.select(axis, k - 1)
        if keepdim:
            vals, inds = vals.unsqueeze(axis), inds.unsqueeze(axis)
        return vals, inds
    return apply_op(fn, x)


def _mode_last(a):
    """Mode over the trailing axis of a (..., n): the smallest modal value
    and the index of its last occurrence."""
    n = a.shape[-1]
    # stable: the gradient of the modal value goes to its first
    # occurrence, as through the JAX package's (stable) sort, on every
    # device
    srt = torch.sort(a, dim=-1, stable=True).values
    flat = srt.reshape(-1, n).contiguous()
    lo = torch.searchsorted(flat, flat, right=False)
    hi = torch.searchsorted(flat, flat, right=True)
    best = torch.argmax(hi - lo, dim=-1).reshape(srt.shape[:-1])
    vals = torch.gather(srt, -1, best.unsqueeze(-1)).squeeze(-1)
    pos = torch.arange(n, device=a.device)
    idx = torch.argmax(torch.where(a == vals.unsqueeze(-1), pos, -1), dim=-1)
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """paddle.mode: the most frequent value along `axis` (the smallest of
    several) and the index of its last occurrence."""
    def fn(a):
        ax = axis % a.dim()
        vals, idx = _mode_last(torch.movedim(a, ax, -1))
        if keepdim:
            vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
        return vals, idx
    return apply_op(fn, x)


def _over(a, axis):
    """a with the reduced axes (None: all) moved last and flattened into
    one, and the shape the result keeps with keepdim."""
    nd = a.dim()
    axes = list(range(nd)) if axis is None else \
        [v % nd for v in (axis if isinstance(axis, (list, tuple))
                          else [axis])]
    rest = [d for d in range(nd) if d not in axes]
    moved = a.permute(rest + axes).reshape(
        [a.shape[d] for d in rest] + [-1])
    keep = [1 if d in axes else a.shape[d] for d in range(nd)]
    return moved, keep


def median(x, axis=None, keepdim=False, name=None):
    """Reference-exact median: even counts average the two middle values;
    float32 out (float64 for a float64 input); axis=None flattens and
    returns shape [1] (keepdim: [1] * ndim); a NaN or +-inf in a slice
    makes it NaN (the reference adds sum(isnan(x) * x), and 0 * inf is
    NaN)."""
    if axis is not None and (not isinstance(axis, int)
                             or not -x.ndim <= axis < x.ndim):
        raise ValueError(
            "In median, axis should be none or an integer in range "
            f"[-rank(x), rank(x)), got {axis!r}")

    def fn(a):
        out_dt = torch.float64 if a.dtype == torch.float64 else torch.float32
        red = a.reshape(-1) if axis is None else a
        ax = 0 if axis is None else axis
        f = red.to(out_dt)
        out = torch.quantile(f, 0.5, dim=ax)
        bad = torch.any(~torch.isfinite(f), dim=ax)
        out = torch.where(bad, torch.nan, out)
        if axis is None:
            return out.reshape([1] * a.dim() if keepdim else [1])
        return out.unsqueeze(axis) if keepdim else out
    return apply_op(fn, x)


def nanmedian(x, axis=None, keepdim=True, name=None):
    """keepdim defaults to True (unlike median), axis may be a list, and
    the output dtype follows the input."""
    if isinstance(axis, (list, tuple)) and not axis:
        raise ValueError("Axis list should not be empty.")

    def fn(a):
        moved, keep = _over(a, axis)
        out = torch.nanquantile(moved.to(_qdt(a)), 0.5, dim=-1).to(a.dtype)
        return out.reshape(keep) if keepdim else out
    return apply_op(fn, x)


def _qdt(a):
    return torch.float64 if a.dtype == torch.float64 else torch.float32


def _check_q(q):
    """q non-empty and each value in [0, 1]; a one-element list acts as a
    scalar."""
    if isinstance(q, (list, tuple)):
        if not q:
            raise ValueError("q should not be empty")
        qs = tuple(float(v) for v in q)
    else:
        qs = (float(q),)
    for v in qs:
        if not 0 <= v <= 1:
            raise ValueError(f"q should be in range [0, 1], but got {v!r}")
    if isinstance(q, (list, tuple)) and len(qs) > 1:
        return qs
    return qs[0]


def _quantile(fn_name, x, q, axis, keepdim):
    qv = _check_q(q)
    qfn = getattr(torch, fn_name)

    def fn(a):
        moved, keep = _over(a, axis)
        f = moved.to(_qdt(a))
        qt = torch.tensor(qv, dtype=f.dtype, device=f.device) \
            if isinstance(qv, tuple) else qv
        out = qfn(f, qt, dim=-1)
        if a.is_floating_point():
            out = out.to(a.dtype)
        if keepdim:
            out = out.reshape(([len(qv)] if isinstance(qv, tuple) else [])
                              + keep)
        return out
    return apply_op(fn, x)


def quantile(x, q, axis=None, keepdim=False, name=None):
    """q a scalar or a list (len > 1: a leading dim of len(q)) in [0, 1];
    axis an int or a list; NaN in a reduced row gives NaN."""
    return _quantile("quantile", x, q, axis, keepdim)
