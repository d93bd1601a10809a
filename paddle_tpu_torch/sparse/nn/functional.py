"""paddle.sparse.nn.functional of the port (counterpart of
`paddle_tpu/sparse/nn/functional.py`)."""
import numpy as np
import torch

from ...core.tensor import Tensor, apply_op
from ...geometric import _rows
from .conv import conv3d, subm_conv3d  # noqa: F401

__all__ = ["conv3d", "subm_conv3d", "relu", "relu6", "leaky_relu",
           "softmax", "max_pool3d", "attention"]


def relu(x, name=None):
    from .. import relu as _relu
    return _relu(x)


def relu6(x, name=None):
    from .. import _values_op
    return _values_op(lambda v: torch.clamp(v, 0, 6), "relu6")(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    from .. import _values_op
    return _values_op(lambda v: torch.nn.functional.leaky_relu(
        v, negative_slope), "leaky_relu")(x)


def _segment_softmax(v, seg, n_rows):
    """softmax of v within each segment (rows of stored entries)."""
    seg = seg.to(v.device)
    shape = (n_rows,) + tuple(v.shape[1:])
    mx = v.detach().new_full(shape, -np.inf).scatter_reduce(
        0, _rows(seg, v), v.detach(), "amax")
    e = torch.exp(v - mx[seg])
    s = e.new_zeros(shape).index_add(0, seg, e)
    return e / s[seg]


def softmax(x, axis=-1, name=None):
    """Softmax over the stored entries of each row: a CSR row, or the COO
    entries sharing every coordinate but the last."""
    from .. import SparseCooTensor, SparseCsrTensor, _host
    if isinstance(x, SparseCsrTensor):
        crows = _host(x.crows_)
        n_rows = len(crows) - 1
        seg = torch.as_tensor(np.repeat(np.arange(n_rows), np.diff(crows)))
        return SparseCsrTensor(x.crows_, x.cols_, apply_op(
            lambda v: _segment_softmax(v, seg, n_rows), x.values_,
            name="sparse_softmax"), x.shape)
    if isinstance(x, SparseCooTensor):
        idx = _host(x.indices_)
        if idx.shape[0] > 1:
            uniq, rows = np.unique(idx[:-1].T, axis=0, return_inverse=True)
            n_rows = len(uniq)
        else:
            rows = idx[0] if idx.shape[0] >= 1 else np.zeros(idx.shape[1])
            n_rows = int(rows.max()) + 1 if rows.size else 1
        seg = torch.as_tensor(np.asarray(rows).reshape(-1).astype(np.int64))
        return SparseCooTensor(x.indices_, apply_op(
            lambda v: _segment_softmax(v, seg, n_rows), x.values_,
            name="sparse_softmax"), x.shape)
    raise TypeError("sparse softmax expects a sparse tensor")


def max_pool3d(x, kernel_size, stride=None, padding=0,
               data_format="NDHWC", name=None):
    """Sparse max pooling over the voxel grid: the output sites are the
    distinct pooled cells of the input sites (numbered in order of first
    appearance, host numpy as the reference), each the max over its
    members."""
    from .. import SparseCooTensor, _host
    k = kernel_size if isinstance(kernel_size, (tuple, list)) \
        else (kernel_size,) * 3
    s = stride or k
    s = s if isinstance(s, (tuple, list)) else (s,) * 3
    p = padding if isinstance(padding, (tuple, list)) else (padding,) * 3
    idx = _host(x.indices_)                          # (4, nnz)
    D, H, W = x.shape[1:4]
    D_out = (D + 2 * p[0] - k[0]) // s[0] + 1
    H_out = (H + 2 * p[1] - k[1]) // s[1] + 1
    W_out = (W + 2 * p[2] - k[2]) // s[2] + 1

    def cell_range(c, pad, kk, st, n_out):
        lo = (c + pad - kk) // st + 1
        hi = (c + pad) // st
        return range(max(lo, 0), min(hi, n_out - 1) + 1)

    cells = {}
    gathers, scatters = [], []
    for i in range(idx.shape[1]):
        b, z, y, xx = idx[:, i]
        for oz in cell_range(z, p[0], k[0], s[0], D_out):
            for oy in cell_range(y, p[1], k[1], s[1], H_out):
                for ox in cell_range(xx, p[2], k[2], s[2], W_out):
                    j = cells.setdefault((b, oz, oy, ox), len(cells))
                    gathers.append(i)
                    scatters.append(j)
    m = len(cells)
    out_idx = np.asarray(sorted(cells, key=cells.get), np.int64).T
    g = torch.as_tensor(np.asarray(gathers, np.int64))
    sc = torch.as_tensor(np.asarray(scatters, np.int64))

    def fn(v):
        gg, ss = g.to(v.device), sc.to(v.device)
        vg = v[gg]
        return v.new_full((m,) + tuple(v.shape[1:]), -np.inf).scatter_reduce(
            0, _rows(ss, vg), vg, "amax")

    out_shape = [x.shape[0], D_out, H_out, W_out, x.shape[-1]]
    vals = apply_op(fn, x.values_, name="sparse_max_pool3d")
    return SparseCooTensor(Tensor(torch.as_tensor(
        out_idx, device=vals._data.device)), vals, out_shape)


def attention(query, key, value, sparse_mask, key_padding_mask=None,
              attn_mask=None, name=None):
    """Attention restricted to the CSR mask's stored positions (plus an
    optional key-padding mask and additive mask): dense scores with -1e9
    outside the pattern, row softmax, weighted sum (as the reference)."""
    from .. import _dense
    dense_mask = _dense(sparse_mask)._data
    has_kpm, has_am = key_padding_mask is not None, attn_mask is not None

    def fn(q, k_, v, *rest):
        it = iter(rest)
        kpm = next(it) if has_kpm else None
        am = next(it) if has_am else None
        zero = q.new_zeros(())
        mask = torch.where(dense_mask.to(q.device) != 0, zero,
                           q.new_full((), -1e9))
        d = q.shape[-1]
        s = q @ k_.transpose(-1, -2) / float(np.sqrt(float(d))) + mask
        if kpm is not None:
            s = s + torch.where(kpm[:, None, None, :] != 0, zero,
                                q.new_full((), -1e9))
        if am is not None:
            s = s + am
        return torch.softmax(s, dim=-1) @ v
    args = [query, key, value] + [t for t in (key_padding_mask, attn_mask)
                                  if t is not None]
    return apply_op(fn, *args, name="sparse_attention")
