"""incubate operators of the port (counterpart of
`paddle_tpu/incubate/operators.py`): graph sampling and reindexing, the
fused softmax-mask functions, the segment reductions and
`identity_loss`.

The graph functions are host code, as in the reference: the sampler is
the reference's numpy sampler, drawing from numpy's global stream, so the
same `np.random.seed` gives the same samples in both packages; the
results go to the device of the input (else the current place).
"""
import numpy as np
import torch

from ..core.tensor import Tensor, apply_op, to_tensor
from ..geometric import (segment_max, segment_mean,  # noqa: F401
                         segment_min, segment_sum)

__all__ = ["graph_send_recv", "graph_sample_neighbors", "graph_khop_sampler",
           "graph_reindex", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle", "identity_loss",
           "segment_sum", "segment_mean", "segment_max", "segment_min"]


def _np(x):
    if isinstance(x, Tensor):
        return x._data.detach().cpu().numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _out(arr, like=None):
    """A host array as a Tensor on `like`'s device (else the current
    place)."""
    place = like._data.device if isinstance(like, Tensor) else None
    return to_tensor(np.ascontiguousarray(arr), place=place)


def graph_send_recv(x, src_index, dst_index, pool_type="sum",
                    out_size=None, name=None):
    """Gather x rows at src_index and reduce them into dst_index slots."""
    from ..geometric import send_u_recv
    return send_u_recv(x, src_index, dst_index, reduce_op=pool_type,
                       out_size=out_size)


def graph_sample_neighbors(row, colptr, input_nodes, eids=None,
                           perm_buffer=None, sample_size=-1,
                           return_eids=False, flag_perm_buffer=False,
                           name=None):
    """Uniform neighbor sampling over a CSC graph, on the host with numpy's
    global stream. A distributed graph handle as `row` (a
    `distributed.ps.DistGraphClient` over sharded graph servers, or a
    local `distributed.ps.GraphTable`) is sampled by the graph store
    (`colptr` is ignored; pass None)."""
    like = input_nodes if isinstance(input_nodes, Tensor) else row
    if hasattr(row, "sample_neighbors") and not isinstance(row, Tensor):
        if return_eids:
            raise ValueError(
                "return_eids is not supported on the distributed GraphTable "
                "path: edge ids are not tracked by the sharded store")
        nb, cnt = row.sample_neighbors(input_nodes, sample_size=sample_size)
        return (_out(np.asarray(nb, np.int64), like),
                _out(np.asarray(cnt, np.int32), like))
    rown, colp, nodes = _np(row), _np(colptr), _np(input_nodes).reshape(-1)
    rng = np.random
    out_nb, out_cnt, out_eids = [], [], []
    eid = _np(eids) if eids is not None else None
    for n in nodes:
        beg, end = int(colp[n]), int(colp[n + 1])
        neigh = rown[beg:end]
        ids = np.arange(beg, end)
        if sample_size > 0 and len(neigh) > sample_size:
            pick = rng.choice(len(neigh), sample_size, replace=False)
            neigh = neigh[pick]
            ids = ids[pick]
        out_nb.append(neigh)
        out_cnt.append(len(neigh))
        if return_eids and eid is not None:
            out_eids.append(eid[ids])
    neighbors = _out(np.concatenate(out_nb) if out_nb
                     else np.zeros(0, rown.dtype), like)
    counts = _out(np.asarray(out_cnt, np.int32), like)
    if return_eids:
        e = _out(np.concatenate(out_eids) if out_eids
                 else np.zeros(0, np.int64), like)
        return neighbors, counts, e
    return neighbors, counts


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None):
    """K-hop sampling: repeated neighbor sampling with a growing frontier.
    Returns (edge_src, edge_dst, sample_index, reindex_x)."""
    like = input_nodes if isinstance(input_nodes, Tensor) else row
    nodes = _np(input_nodes).reshape(-1)
    all_src, all_dst = [], []
    frontier = nodes
    seen = list(nodes)
    for k in sample_sizes:
        nb, cnt = graph_sample_neighbors(row, colptr, frontier,
                                         sample_size=int(k))
        nbn, cntn = _np(nb), _np(cnt)
        dst = np.repeat(frontier, cntn)
        all_src.append(nbn)
        all_dst.append(dst)
        frontier = np.unique(nbn)
        seen.extend(frontier.tolist())
    src = np.concatenate(all_src) if all_src else np.zeros(0, np.int64)
    dst = np.concatenate(all_dst) if all_dst else np.zeros(0, np.int64)
    uniq = np.asarray(sorted(set(seen)), dtype=src.dtype if src.size
                      else np.int64)
    remap = {int(v): i for i, v in enumerate(uniq)}
    src_r = np.asarray([remap[int(s)] for s in src], np.int64)
    dst_r = np.asarray([remap[int(d)] for d in dst], np.int64)
    return (_out(src_r, like), _out(dst_r, like), _out(uniq, like),
            _out(np.asarray([remap[int(n)] for n in nodes], np.int64), like))


def graph_reindex(x, neighbors, count, value_buffer=None, index_buffer=None,
                  flag_buffer_hashtable=False, name=None):
    """Contiguous reindex of (x ∪ neighbors). Returns (reindex_src,
    reindex_dst, out_nodes)."""
    xs, nb, cnt = _np(x).reshape(-1), _np(neighbors), _np(count)
    out_nodes, remap = [], {}
    for v in np.concatenate([xs, nb]):
        if int(v) not in remap:
            remap[int(v)] = len(out_nodes)
            out_nodes.append(int(v))
    reindex_src = np.asarray([remap[int(v)] for v in nb], np.int64)
    dst = np.repeat(xs, cnt[:len(xs)])
    reindex_dst = np.asarray([remap[int(v)] for v in dst], np.int64)
    return (_out(reindex_src, x), _out(reindex_dst, x),
            _out(np.asarray(out_nodes, np.int64), x))


def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) over the last axis."""
    return apply_op(lambda a, m: torch.softmax(a + m, dim=-1), x, mask,
                    name="softmax_mask_fuse")


def softmax_mask_fuse_upper_triangle(x, name=None):
    """Causal softmax over the last two dims: scores above the diagonal
    are set to -1e9."""
    def fn(a):
        row = torch.arange(a.shape[-2], device=a.device)[:, None]
        col = torch.arange(a.shape[-1], device=a.device)[None]
        masked = torch.where(row >= col, a, a.new_full((), -1e9))
        return torch.softmax(masked, dim=-1)
    return apply_op(fn, x, name="softmax_mask_fuse_upper_triangle")


def identity_loss(x, reduction="none"):
    """x reduced by `reduction` (0 sum, 1 mean, 2 none): the identity that
    marks a loss output."""
    red = {0: "sum", 1: "mean", 2: "none"}.get(reduction, reduction)
    if red == "mean":
        return apply_op(torch.mean, x, name="identity_loss")
    if red == "sum":
        return apply_op(torch.sum, x, name="identity_loss")
    return x
