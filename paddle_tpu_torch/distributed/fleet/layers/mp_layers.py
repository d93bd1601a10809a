"""Megatron tensor-parallel layers (counterpart of
`paddle_tpu/distributed/fleet/layers/mp_layers.py`; reference:
python/paddle/distributed/fleet/layers/mpu/mp_layers.py
VocabParallelEmbedding:39, ColumnParallelLinear:155,
RowParallelLinear:293, ParallelCrossEntropy:438, and mp_ops.py).

The parameters carry the reference's marks: `is_distributed` and
`split_axis` (the embedding's rows, a column layer's output columns and
bias, a row layer's input rows), which `param_partition_spec`, `Model`'s
mp route and the sharding wrappers read. Each layer has the reference's
three contexts:

  * no live mp axis, and full weights: the plain op;
  * a one-controller manual region (`env.axis_context(mp="mp")` over a
    mesh whose mp axis is above 1): each mp rank's piece is computed from
    its slice of the full weight and the pieces are combined with the
    list collectives of `parallel/collectives.py` (`psum` in f32 in rank
    order, `all_gather`, `pmax`), whose autograd is their transpose. The
    value handed on is the one every rank holds; where the reference
    hands on a shard (a column layer without `gather_output`, a row
    layer's `input_is_parallel` input, the parallel cross entropy's
    logits) the port hands on the ranks' shards concatenated along the
    split axis, so elementwise layers between them act on every shard;
  * across processes, one mp rank a process (`shard_mp_params` has cut
    each marked parameter to this process's rows, `_mp_local`): the
    reference's manual functions `_c_identity`, `_mp_allreduce`,
    `_c_split` and `_c_concat` as `torch.autograd.Function`s over the
    `torch.distributed` group of the mp axis (staged through the host
    under gloo). Every process computes the same loss; each holds the
    gradient of its own shard and identical gradients of the replicated
    parameters.
"""
import torch

from ....core.tensor import apply_op
from ....nn import functional as F
from ....nn.initializer import XavierUniform
from ....nn.layer.layers import Layer
from ....parallel import collectives as C
from ... import env
from ...collective import ReduceOp, _world_gather, _world_reduce

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "shard_mp_params"]


def _region_mp():
    """The live mp axis's size in a one-controller manual region, or
    None."""
    axis = env.current_axis_name("mp")
    mesh = env.get_mesh()
    if axis is None or mesh is None or mesh.dims.get(axis, 1) <= 1:
        return None
    return mesh.dims[axis]


def _local(p):
    """(mp rank, mp size, process group) of a parameter cut by
    `shard_mp_params`, else None."""
    return getattr(p, "_mp_local", None)


def shard_mp_params(layer, rank, n, pg):
    """Cut every parameter of `layer` marked `is_distributed` with a
    `split_axis` to mp rank `rank`'s block of `n` along that axis (each
    process of the mp group keeps its own), in place; idempotent."""
    for p in layer.parameters():
        ax = getattr(p, "split_axis", None)
        if not getattr(p, "is_distributed", False) or ax is None or \
                _local(p) is not None:
            continue
        size = p._data.shape[ax]
        if size % n:
            raise ValueError(f"parameter {p.name}: dim {ax} of "
                             f"{tuple(p._data.shape)} does not split over "
                             f"mp={n}")
        per = size // n
        with torch.no_grad():
            piece = p._data.narrow(ax, rank * per, per).clone()
        p._rebind(lambda d, v=piece: v, tracked=False)
        p._mp_local = (rank, n, pg)


# ---------------------------------------------------------------------------
# across processes: the reference's manual functions over the mp group
# ---------------------------------------------------------------------------

def _allreduce(x, pg, op=ReduceOp.SUM):
    """SUM (in f32 for narrower floats) or MAX over the mp group."""
    return _world_reduce(x, op, pg)


def _gather_last(x, pg):
    return torch.cat(_world_gather(x, pg), -1)


class _CIdentity(torch.autograd.Function):
    """Identity forward, all-reduce backward (mp_ops.py _c_identity)."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _allreduce(g, ctx.pg), None


class _MpAllreduce(torch.autograd.Function):
    """All-reduce forward, identity backward (mp_ops.py _mp_allreduce)."""

    @staticmethod
    def forward(ctx, x, pg):
        return _allreduce(x, pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CSplit(torch.autograd.Function):
    """This rank's block of the last dim forward, all-gather backward
    (mp_ops.py _c_split)."""

    @staticmethod
    def forward(ctx, x, rank, n, pg):
        ctx.pg = pg
        per = x.shape[-1] // n
        return x[..., rank * per:(rank + 1) * per].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.pg), None, None, None


class _CConcat(torch.autograd.Function):
    """All-gather of the last dim forward, this rank's block backward
    (mp_ops.py _c_concat)."""

    @staticmethod
    def forward(ctx, x, rank, n, pg):
        ctx.rank, ctx.per = rank, x.shape[-1]
        return _gather_last(x, pg)

    @staticmethod
    def backward(ctx, g):
        r, per = ctx.rank, ctx.per
        return g[..., r * per:(r + 1) * per].contiguous(), None, None, None


# ---------------------------------------------------------------------------
# one controller: each rank's piece from its slice of the full weight
# ---------------------------------------------------------------------------

def _blocks(t, n, dim):
    return list(t.chunk(n, dim))


def _psum1(parts):
    """The group's f32 rank-order sum, once (every rank holds it)."""
    return C.psum(parts)[0]


def _masked_lookup(ids, w, start):
    per = w.shape[0]
    idx = ids.to(torch.int64) - start
    ok = (idx >= 0) & (idx < per)
    rows = w[idx.clamp(0, per - 1)]
    return torch.where(ok[..., None], rows, torch.zeros((), dtype=w.dtype,
                                                         device=w.device))


class VocabParallelEmbedding(Layer):
    """Embedding with the vocab rows split over mp (reference
    mp_layers.py:39: a rank looks up its [start, end) rows, masks the
    others and the ranks' rows are summed)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=XavierUniform())
        self.weight.is_distributed = True
        self.weight.split_axis = 0

    def forward(self, x):
        loc = _local(self.weight)
        if loc is not None:
            rank, n, pg = loc

            def fn(ids, w):
                return _MpAllreduce.apply(
                    _masked_lookup(ids, w, rank * w.shape[0]), pg)
            return apply_op(fn, x, self.weight, name="vocab_parallel_embedding")
        n = _region_mp()
        if n is None:
            return F.embedding(x, self.weight)

        def region(ids, w):
            per = w.shape[0] // n
            return _psum1([_masked_lookup(ids, wr, r * per)
                           for r, wr in enumerate(_blocks(w, n, 0))])
        return apply_op(region, x, self.weight,
                        name="vocab_parallel_embedding")


class ColumnParallelLinear(Layer):
    """Linear with out_features split over mp (reference
    mp_layers.py:155)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=XavierUniform())
        self.weight.is_distributed = True
        self.weight.split_axis = 1
        if has_bias is False:
            self.bias = None
        else:
            self.bias = self.create_parameter((out_features,), is_bias=True)
            self.bias.is_distributed = True
            self.bias.split_axis = 0

    def _args(self, x):
        return (x, self.weight) if self.bias is None else \
            (x, self.weight, self.bias)

    def forward(self, x):
        loc = _local(self.weight)
        if loc is not None:
            rank, n, pg = loc

            def fn(a, w, *b):
                out = _CIdentity.apply(a, pg) @ w
                if b:
                    out = out + b[0]
                if self.gather_output:
                    out = _CConcat.apply(out, rank, n, pg)
                return out
            return apply_op(fn, *self._args(x), name="column_parallel_linear")
        n = _region_mp()
        if n is None:
            return F.linear(x, self.weight, self.bias)

        def region(a, w, *b):
            ws = _blocks(w, n, 1)
            bs = _blocks(b[0], n, 0) if b else [None] * n
            outs = [a @ wr + br if br is not None else a @ wr
                    for wr, br in zip(ws, bs)]
            return C.all_gather(outs, -1)[0]
        return apply_op(region, *self._args(x), name="column_parallel_linear")


class RowParallelLinear(Layer):
    """Linear with in_features split over mp (reference
    mp_layers.py:293)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=XavierUniform())
        self.weight.is_distributed = True
        self.weight.split_axis = 0
        self.bias = self.create_parameter((out_features,), is_bias=True) \
            if has_bias else None

    def _args(self, x):
        return (x, self.weight) if self.bias is None else \
            (x, self.weight, self.bias)

    def forward(self, x):
        loc = _local(self.weight)
        if loc is not None:
            rank, n, pg = loc

            def fn(a, w, *b):
                if not self.input_is_parallel:
                    a = _CSplit.apply(a, rank, n, pg)
                out = _MpAllreduce.apply(a @ w, pg)
                if b:
                    out = out + b[0]
                return out
            return apply_op(fn, *self._args(x), name="row_parallel_linear")
        n = _region_mp()
        if n is None:
            return F.linear(x, self.weight, self.bias)

        def region(a, w, *b):
            # a parallel input arrives as the ranks' shards concatenated;
            # either way rank r takes its block of the last dim
            parts = [ar @ wr for ar, wr in zip(_blocks(a, n, -1),
                                                _blocks(w, n, 0))]
            out = _psum1(parts)
            return out + b[0] if b else out
        return apply_op(region, *self._args(x), name="row_parallel_linear")


def _parallel_ce(logits, lab, starts, pmax, psum):
    """The vocab-parallel softmax cross entropy of the ranks' logit shards
    (lists), with `pmax` / `psum` over the ranks: one [..., 1] loss."""
    local_max = [lg.amax(-1, keepdim=True) for lg in logits]
    gmax = pmax([m.detach() for m in local_max])
    shifted = [lg - m for lg, m in zip(logits, gmax)]
    gsum = psum([torch.exp(s).sum(-1, keepdim=True) for s in shifted])
    li = lab.to(torch.int64)
    if li.dim() == logits[0].dim():
        li = li[..., 0]
    picked = []
    for s, start in zip(shifted, starts):
        per = s.shape[-1]
        idx = li - start
        ok = (idx >= 0) & (idx < per)
        pk = s.gather(-1, idx.clamp(0, per - 1)[..., None])[..., 0]
        picked.append(torch.where(ok, pk, torch.zeros((), dtype=pk.dtype,
                                                      device=pk.device)))
    picked = psum(picked)
    return [(torch.log(g)[..., 0] - p)[..., None]
            for g, p in zip(gsum, picked)]


class ParallelCrossEntropy(Layer):
    """Vocab-parallel softmax cross entropy (reference mp_layers.py:438):
    the logits are split on the class dim and the softmax normalizer is
    summed over the ranks, so no rank holds the full row."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        hcg_loc = _ce_process_mp()
        if hcg_loc is not None:
            rank, n, pg = hcg_loc

            def fn(logits, lab):
                per = logits.shape[-1]
                return _parallel_ce(
                    [logits], lab, [rank * per],
                    lambda ms: [_allreduce(ms[0], pg, ReduceOp.MAX)],
                    lambda xs: [_MpAllreduce.apply(xs[0], pg)])[0]
            return apply_op(fn, input, label, name="parallel_cross_entropy")
        n = _region_mp()
        if n is None:
            return F.cross_entropy(input, label, reduction="none",
                                   ignore_index=self.ignore_index)

        def region(logits, lab):
            shards = _blocks(logits, n, -1)
            per = shards[0].shape[-1]
            return _parallel_ce(shards, lab, [r * per for r in range(n)],
                                C.pmax, C.psum)[0]
        return apply_op(region, input, label, name="parallel_cross_entropy")


def _ce_process_mp():
    """(mp rank, mp size, process group) when fleet's mp axis spans the
    processes one rank a process (the logits this layer gets are then a
    process's shard), else None."""
    from .. import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_model_parallel_world_size() <= 1 or \
            env.in_manual_region():
        return None
    group = hcg.get_model_parallel_group()
    if not group.spans_processes():
        return None
    return (hcg.get_model_parallel_rank(),
            hcg.get_model_parallel_world_size(), group.process_group)
