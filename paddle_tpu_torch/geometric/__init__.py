"""paddle.geometric of the port (counterpart of
`paddle_tpu/geometric/__init__.py`): graph message passing and segment
pooling.

Each reduction is one scatter on the input's device: `index_add` for sum
and mean, `scatter_reduce` ("amax" / "amin" over a ±inf start) for max and
min, all recorded by autograd. As in the reference, a max or min whose
result is not finite reads 0: an empty segment, and also a segment whose
true result is ±inf (the reference's `jnp.where(isfinite)` zeroes both).
"""
import numpy as np
import torch

from ..core.tensor import Tensor, apply_op, to_tensor

__all__ = ["send_u_recv", "send_ue_recv", "send_uv", "segment_sum",
           "segment_mean", "segment_max", "segment_min", "sample_neighbors",
           "reindex_graph", "reindex_heter_graph"]


def _rows(idx, vals):
    """A row index broadcast to vals' shape (for scatter_reduce)."""
    return idx.reshape((-1,) + (1,) * (vals.dim() - 1)).expand(vals.shape)


def _seg_reduce(vals, idx, n, pool):
    idx = idx.to(device=vals.device, dtype=torch.int64)
    shape = (n,) + tuple(vals.shape[1:])
    if pool == "sum":
        return vals.new_zeros(shape).index_add(0, idx, vals)
    if pool == "mean":
        tot = vals.new_zeros(shape).index_add(0, idx, vals)
        cnt = vals.new_zeros((n,)).index_add(
            0, idx, vals.new_ones(idx.shape))
        return tot / cnt.clamp_min(1.0).reshape((n,) + (1,) *
                                                (vals.dim() - 1))
    if pool in ("max", "min"):
        init = vals.new_full(shape, -np.inf if pool == "max" else np.inf)
        out = init.scatter_reduce(0, _rows(idx, vals), vals,
                                  "amax" if pool == "max" else "amin")
        return torch.where(torch.isfinite(out), out, out.new_zeros(()))
    raise ValueError(f"unknown pool_type {pool!r}")


def _index(t):
    if isinstance(t, Tensor):
        return t._data
    return torch.as_tensor(np.asarray(t))


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """Gather x[src] and segment-reduce onto dst."""
    src, dst = _index(src_index), _index(dst_index)
    n = int(out_size) if out_size is not None else int(x.shape[0])

    def fn(xr):
        return _seg_reduce(xr[src.to(xr.device)], dst, n, reduce_op)

    return apply_op(fn, x, name="send_u_recv")


_MESSAGE = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
            "div": torch.div}


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """Like send_u_recv, but combines node features x[src] with the edge
    features y before reducing."""
    src, dst = _index(src_index), _index(dst_index)
    n = int(out_size) if out_size is not None else int(x.shape[0])
    comb = _MESSAGE[message_op]
    yy = y if isinstance(y, Tensor) else to_tensor(
        np.asarray(y), place=x._data.device)

    def fn(xr, yr):
        return _seg_reduce(comb(xr[src.to(xr.device)], yr), dst, n,
                           reduce_op)

    return apply_op(fn, x, yy, name="send_ue_recv")


def _segment(x, segment_ids, pool):
    seg = _index(segment_ids)
    n = int(seg.max()) + 1 if seg.numel() else 0

    def fn(xr):
        return _seg_reduce(xr, seg, n, pool)

    return apply_op(fn, x, name=f"segment_{pool}")


def segment_sum(x, segment_ids, name=None):
    return _segment(x, segment_ids, "sum")


def segment_mean(x, segment_ids, name=None):
    return _segment(x, segment_ids, "mean")


def segment_max(x, segment_ids, name=None):
    return _segment(x, segment_ids, "max")


def segment_min(x, segment_ids, name=None):
    return _segment(x, segment_ids, "min")


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """A message per edge from both endpoints: out[e] = x[src[e]] op
    y[dst[e]]."""
    def fn(xd, yd, si, di):
        return _MESSAGE[message_op](xd[si.to(xd.device).long()],
                                    yd[di.to(yd.device).long()])
    return apply_op(fn, x, y, src_index, dst_index, name="send_uv")


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    """Uniform neighbor sampling (`incubate.graph_sample_neighbors`). A
    `distributed.ps.DistGraphClient` or a local `GraphTable` as `row`
    (with colptr=None) samples on the sharded graph store."""
    from ..incubate.operators import graph_sample_neighbors
    return graph_sample_neighbors(row, colptr, input_nodes, eids=eids,
                                  sample_size=sample_size,
                                  return_eids=return_eids)


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    from ..incubate.operators import graph_reindex
    return graph_reindex(x, neighbors, count)


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """Neighbor lists of several edge types reindexed against one shared
    node mapping (host numpy, as in the reference)."""
    from ..incubate.operators import _np, _out
    xs = _np(x).reshape(-1)
    remap = {}
    out_nodes = []
    for v in xs:
        if int(v) not in remap:
            remap[int(v)] = len(out_nodes)
            out_nodes.append(int(v))
    srcs, dsts = [], []
    for nb, cnt in zip(neighbors, count):
        nbn, cnn = _np(nb), _np(cnt)
        for v in nbn:
            if int(v) not in remap:
                remap[int(v)] = len(out_nodes)
                out_nodes.append(int(v))
        srcs.append(np.asarray([remap[int(v)] for v in nbn], np.int64))
        dsts.append(np.asarray([remap[int(v)] for v in
                                np.repeat(xs, cnn[:len(xs)])], np.int64))
    return (_out(np.concatenate(srcs), x), _out(np.concatenate(dsts), x),
            _out(np.asarray(out_nodes, np.int64), x))
