"""Shape and layout ops (counterpart of
`paddle_tpu/tensor/manipulation.py`). Views that torch returns (reshape,
transpose, split, slicing) are safe to hand out: the port never writes
into a Tensor's storage (`core/tensor.py`)."""
import builtins as _builtins

import torch

from ..core.tensor import Tensor, _wrap, apply_op, to_tensor

__all__ = [
    "reshape", "reshape_", "flatten", "squeeze", "unsqueeze", "transpose",
    "t", "moveaxis", "swapaxes", "concat", "stack", "split", "chunk",
    "unbind", "tile", "expand", "expand_as", "broadcast_to",
    "broadcast_tensors", "flip", "roll", "rot90", "gather", "gather_nd",
    "take_along_axis", "put_along_axis", "scatter", "scatter_nd_add",
    "scatter_nd", "index_select", "index_sample", "masked_select", "slice",
    "strided_slice", "unique", "unique_consecutive", "repeat_interleave",
    "as_real", "as_complex", "tensordot", "shard_index"]


def _dim(s):
    """One entry of a shape argument as an int; a symbolic size (a
    torch.export trace's dynamic dim) stays symbolic."""
    if isinstance(s, torch.SymInt):
        return s
    return int(s._data) if isinstance(s, Tensor) else int(s)


def _shape_arg(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy().reshape(-1))
    return tuple(_dim(s) for s in shape)


def _int(v):
    return int(v._data) if isinstance(v, Tensor) else int(v)


def reshape(x, shape, name=None):
    shp = _shape_arg(shape)
    return apply_op(lambda a: torch.reshape(a, shp), x)


def reshape_(x, shape, name=None):
    return x._rebind(lambda d: reshape(_wrap(d), shape)._data)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def fn(a):
        nd = a.dim()
        s = start_axis % nd if nd else 0
        e = stop_axis % nd if nd else 0
        return torch.reshape(a, tuple(a.shape[:s]) + (-1,)
                             + tuple(a.shape[e + 1:]))
    return apply_op(fn, x)


def squeeze(x, axis=None, name=None):
    def fn(a):
        if axis is None:
            return torch.squeeze(a)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = tuple(ax % a.dim() for ax in axes if a.shape[ax % a.dim()] == 1)
        return torch.squeeze(a, axes) if axes else a
    return apply_op(fn, x)


def unsqueeze(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = sorted(_int(a) for a in axes)

    def fn(a):
        out = a
        for ax in axes:
            out = torch.unsqueeze(out, ax)
        return out
    return apply_op(fn, x)


def transpose(x, perm=None, name=None):
    def fn(a):
        p = tuple(reversed(range(a.dim()))) if perm is None else tuple(perm)
        return a.permute(p)
    return apply_op(fn, x)


def t(x, name=None):
    return apply_op(lambda a: a.permute(tuple(reversed(range(a.dim()))))
                    if a.dim() >= 2 else a, x)


def moveaxis(x, source, destination, name=None):
    return apply_op(lambda a: torch.movedim(a, source, destination), x)


def swapaxes(x, axis0, axis1, name=None):
    return apply_op(lambda a: torch.swapaxes(a, axis0, axis1), x)


def concat(x, axis=0, name=None):
    ax = _int(axis)
    return apply_op(lambda *xs: torch.cat(xs, ax), *x)


def stack(x, axis=0, name=None):
    return apply_op(lambda *xs: torch.stack(xs, axis), *x)


def split(x, num_or_sections, axis=0, name=None):
    axis = _int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split: dimension {dim} along axis {axis} is not divisible "
                f"by {num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(s) for s in num_or_sections]
        if _builtins.any(s < 0 for s in sizes):
            known = _builtins.sum(s for s in sizes if s >= 0)
            sizes = [s if s >= 0 else dim - known for s in sizes]
    return list(apply_op(lambda a: torch.split(a, sizes, axis), x))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return list(apply_op(lambda a: torch.unbind(a, axis), x))


def tile(x, repeat_times, name=None):
    reps = _shape_arg(repeat_times)
    return apply_op(lambda a: torch.tile(a, reps), x)


def expand(x, shape, name=None):
    tgt = _shape_arg(shape)

    def fn(a):
        full = list(tgt)
        src = [1] * (len(full) - a.dim()) + list(a.shape)
        for i, s in enumerate(full):
            if s == -1:                  # paddle: -1 keeps the dim
                full[i] = src[i]
        return torch.broadcast_to(a, tuple(full))
    return apply_op(fn, x)


def expand_as(x, y, name=None):
    return apply_op(lambda a: torch.broadcast_to(a, tuple(y._data.shape)), x)


def broadcast_to(x, shape, name=None):
    shp = _shape_arg(shape)
    return apply_op(lambda a: torch.broadcast_to(a, shp), x)


def broadcast_tensors(inputs, name=None):
    tgt = torch.broadcast_shapes(*[tuple(t.shape) for t in inputs])
    return [broadcast_to(t, tgt) for t in inputs]


def flip(x, axis, name=None):
    axes = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return apply_op(lambda a: torch.flip(a, axes), x)


def roll(x, shifts, axis=None, name=None):
    return apply_op(lambda a: torch.roll(a, shifts, axis), x)


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply_op(lambda a: torch.rot90(a, k, tuple(axes)), x)


def gather(x, index, axis=0, name=None):
    ax = _int(axis)
    return apply_op(lambda a, i: torch.index_select(a, ax, i.reshape(-1)
                                                    .long()), x, index)


def gather_nd(x, index, name=None):
    return apply_op(lambda a, i: a[tuple(i.long().movedim(-1, 0))],
                    x, index)


def take_along_axis(arr, indices, axis, name=None):
    return apply_op(lambda a, i: torch.take_along_dim(a, i.long(), axis),
                    arr, indices)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    if not isinstance(values, Tensor):
        values = to_tensor(values, dtype=arr.dtype, place=arr.place)

    def fn(a, i, v):
        i = i.long()
        v = torch.broadcast_to(v, i.shape).to(a.dtype)
        if reduce == "add":
            return torch.scatter_add(a, axis, i, v)
        if reduce in ("multiply", "mul"):
            return torch.scatter_reduce(a, axis, i, v, "prod")
        return torch.scatter(a, axis, i, v)
    return apply_op(fn, arr, indices, values)


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows of `updates` into x along axis 0; overwrite=False zeroes the
    destination rows and sums duplicates."""
    def fn(a, i, u):
        i = i.reshape(-1).long()
        u = u.to(a.dtype)
        if overwrite:
            return a.index_put((i,), u)
        return a.index_fill(0, i, 0).index_add(0, i, u)
    return apply_op(fn, x, index, updates)


def scatter_nd_add(x, index, updates, name=None):
    return apply_op(lambda a, i, u: a.index_put(
        tuple(i.long().movedim(-1, 0)), u.to(a.dtype), accumulate=True),
        x, index, updates)


def scatter_nd(index, updates, shape, name=None):
    zeros = _wrap(torch.zeros(_shape_arg(shape), dtype=updates.dtype,
                              device=updates._data.device))
    return scatter_nd_add(zeros, index, updates)


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis)


def index_sample(x, index):
    return apply_op(lambda a, i: torch.gather(a, 1, i.long()), x, index)


def masked_select(x, mask, name=None):
    return apply_op(lambda a, m: torch.masked_select(
        a, torch.broadcast_to(m.bool(), a.shape)), x, mask)


def slice(input, axes, starts, ends, name=None):
    def fn(a):
        idx = [_builtins.slice(None)] * a.dim()
        for ax, s, e in zip(axes, starts, ends):
            idx[ax] = _builtins.slice(_int(s), _int(e))
        return a[tuple(idx)]
    return apply_op(fn, input)


def strided_slice(x, axes, starts, ends, strides, name=None):
    def fn(a):
        out = a
        for ax, s, e, st in zip(axes, starts, ends, strides):
            s, e, st = _int(s), _int(e), _int(st)
            if st > 0:
                idx = [_builtins.slice(None)] * a.dim()
                idx[ax] = _builtins.slice(s, e, st)
                out = out[tuple(idx)]
            else:                        # torch slicing takes no step < 0
                rows = range(*_builtins.slice(s, e, st).indices(
                    out.shape[ax]))
                out = torch.index_select(out, ax, torch.tensor(
                    list(rows), dtype=torch.long, device=out.device))
        return out
    return apply_op(fn, x)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """Sorted unique values (and first indices, inverse, counts) as
    `np.unique` gives them, computed on x's device: NaNs count as one
    value, the inverse takes x's shape when `axis` is None."""
    a = x._data.detach()
    if axis is None:
        flat = a.reshape(-1)
        s, perm = torch.sort(flat, stable=True)
        new = torch.ones_like(s, dtype=torch.bool)
        step = s[1:] != s[:-1]
        if s.is_floating_point():
            step &= ~(torch.isnan(s[1:]) & torch.isnan(s[:-1]))
        new[1:] = step
        starts = torch.nonzero(new).reshape(-1)
        vals = s[starts]
        first = perm[starts]             # the sort is stable
        inv = torch.empty_like(perm)
        inv[perm] = torch.cumsum(new, 0) - 1
        inv = inv.reshape(a.shape)
        counts = torch.diff(starts, append=starts.new_tensor([flat.numel()]))
    else:
        vals, inv, counts = torch.unique(
            a, sorted=True, return_inverse=True, return_counts=True,
            dim=axis)
        n = inv.numel()
        first = torch.full((counts.numel(),), n, dtype=torch.long,
                           device=a.device).scatter_reduce(
            0, inv, torch.arange(n, device=a.device), "amin")
    res = [vals] + [r for r, want in ((first, return_index),
                                      (inv, return_inverse),
                                      (counts, return_counts)) if want]
    if len(res) == 1:
        return _wrap(vals)
    return tuple(_wrap(r) for r in res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, name=None):
    a = x._data.detach()
    data = a.reshape(-1) if axis is None else a
    keep = torch.ones(len(data), dtype=torch.bool, device=a.device)
    keep[1:] = data[1:] != data[:-1]
    return _wrap(data[keep])


def repeat_interleave(x, repeats, axis=None, name=None):
    r = repeats._data if isinstance(repeats, Tensor) else repeats
    return apply_op(lambda a: torch.repeat_interleave(
        a if axis is not None else a.reshape(-1), r,
        axis if axis is not None else 0), x)


def as_real(x, name=None):
    return apply_op(lambda a: torch.stack([torch.real(a), torch.imag(a)],
                                          -1), x)


def as_complex(x, name=None):
    return apply_op(lambda a: torch.complex(a[..., 0], a[..., 1]), x)


def tensordot(x, y, axes=2, name=None):
    return apply_op(lambda a, b: torch.tensordot(a, b, dims=axes), x, y)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    def fn(a):
        size = index_num // nshards
        lo, hi = shard_id * size, (shard_id + 1) * size
        in_range = (a >= lo) & (a < hi)
        return torch.where(in_range, a - lo, ignore_value)
    return apply_op(fn, input)
