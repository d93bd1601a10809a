"""Collectives over per-rank tensors, for one controller that drives every
rank of a mesh.

The JAX training step (`paddle_tpu/parallel/gpt_spmd.py`) runs one rank's
body under `shard_map` and calls `lax` collectives by axis name. Here one
process holds every rank's tensors and runs the ranks in lockstep, so a
collective is a function of the list of tensors that the ranks of one
group hold, in the order of their index on the axis. It returns that
list's counterpart: output i belongs to rank i and lies on the device of
input i, and no two outputs share storage.

`RankGrid` lays ranks out over `AXES` in the order `MeshPlan.build_mesh`
reshapes devices (rank id = the row-major index of its coordinates) and
applies a group collective to every group of an axis (`over`); the
mesh of `distributed.env.build_mesh` is a `RankGrid` over the axes it
names, in the order it names them.

Across processes. The ranks of a grid split over `nproc` processes, one
block of device slots a process; a rank's slot is its row-major index over
`order` (the axes slowest first: the reference's device-array transpose),
so the axis named first is the one whose groups span the processes. A
group of `over` whose members lie in other processes gathers them through
a `torch.distributed` group of those processes (`_ProcGather`), runs the
group collective on the whole group in every member process, and keeps its
own members' outputs: the same sums in the same order as one controller.
The gather's backward sums the processes' cotangents of each member and
hands them to its owner, so autograd through `over` gives each rank the
gradient one controller gives it. Each process receives (members - 1) x
the value's bytes of a group, more than a ring reduce-scatter's
(n - 1)/n: the price of one controller's order.

Autograd. The collectives are plain differentiable ops, and the gradient
autograd gives each is the transpose JAX gives it under `check_vma=False`:
all_gather's is a reduce-scatter, ppermute's the inverse permutation,
all_to_all's the reverse exchange, psum's a psum. The model code also needs
the JAX module's two custom VJPs, ported literally as autograd Functions:
`axis_psum` (psum forward, identity backward: Megatron's g) and `mp_copy`
(identity forward, psum backward: Megatron's f). Every rank computes its
own loss and the step back-propagates their sum: with the two markers,
that gives each rank exactly its JAX gradient, not a sum of it over the
axis.

Sums run in float32 in rank order and are cast back to the input's dtype.
"""
import math

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AXES", "RankGrid", "psum", "pmean", "pmax", "all_gather",
           "psum_scatter", "ppermute", "all_to_all", "axis_psum", "mp_copy",
           "axis_index"]

AXES = ("dp", "pp", "sharding", "sp", "mp")


def _sum_f32(xs, device):
    acc = xs[0].to(device, torch.float32)
    for x in xs[1:]:
        acc = acc + x.to(device, torch.float32)
    return acc


def _spread(s, xs):
    """One copy of `s` a rank, in rank i's dtype on rank i's device; the
    first rank keeps `s` itself when it is a fresh tensor."""
    return [s.to(x.device, x.dtype, copy=i > 0 or s is x)
            for i, x in enumerate(xs)]


def psum(xs):
    """Sum over the group; every rank gets the sum."""
    if len(xs) == 1:
        return list(xs)
    return _spread(_sum_f32(xs, xs[0].device), xs)


def pmean(xs):
    """Mean over the group; every rank gets it."""
    if len(xs) == 1:
        return list(xs)
    return _spread(_sum_f32(xs, xs[0].device) / len(xs), xs)


def pmax(xs):
    """Element-wise max over the group; every rank gets it."""
    if len(xs) == 1:
        return list(xs)
    dev = xs[0].device
    m = xs[0]
    for x in xs[1:]:
        m = torch.maximum(m, x.to(dev))
    return [m.to(x.device, copy=True) for x in xs]


def all_gather(xs, dim):
    """Tiled all-gather: rank i gets the ranks' tensors concatenated along
    `dim` in rank order."""
    return [torch.cat([x.to(t.device) for x in xs], dim) for t in xs]


def psum_scatter(xs, dim):
    """Tiled reduce-scatter: rank i gets the i-th of n equal chunks of the
    sum along `dim`."""
    n = len(xs)
    if xs[0].shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of size "
                         f"{xs[0].shape[dim]} does not split {n} ways")
    s = _sum_f32(xs, xs[0].device)
    return [c.to(x.device, x.dtype, copy=True)
            for c, x in zip(s.chunk(n, dim), xs)]


def ppermute(xs, shift=1):
    """Rank i's tensor moves to rank (i + shift) mod n (a copy)."""
    n = len(xs)
    out = [None] * n
    for i, x in enumerate(xs):
        j = (i + shift) % n
        out[j] = x.to(xs[j].device, copy=True)
    return out


def all_to_all(xs, split_dim, concat_dim):
    """Tiled all-to-all: rank i gets the i-th chunk of every rank's tensor
    along `split_dim`, concatenated along `concat_dim` in source order."""
    n = len(xs)
    if xs[0].shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{xs[0].shape[split_dim]} does not split {n} ways")
    parts = [x.chunk(n, split_dim) for x in xs]
    return [torch.cat([p[i].to(t.device) for p in parts], concat_dim)
            for i, t in enumerate(xs)]


class _AxisPsum(torch.autograd.Function):
    """psum forward, identity backward (JAX `_axis_psum`)."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(_spread(_sum_f32(xs, xs[0].device), xs))

    @staticmethod
    def backward(ctx, *gs):
        return gs


class _MpCopy(torch.autograd.Function):
    """Identity forward, psum backward (JAX `_mp_copy`)."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return tuple(_spread(_sum_f32(gs, gs[0].device), gs))


def axis_psum(xs):
    """psum whose backward hands each rank its own cotangent: every use of
    the sum feeds computation replicated over the axis, so the true
    cotangent is replicated and the transpose is the identity."""
    return list(xs) if len(xs) == 1 else list(_AxisPsum.apply(*xs))


def mp_copy(xs):
    """Identity whose backward sums the ranks' cotangents: the input of a
    computation sharded over the axis (each rank sees its own weight
    shard), so upstream replicated tensors collect every rank's part."""
    return list(xs) if len(xs) == 1 else list(_MpCopy.apply(*xs))


def axis_index(grid, rank, axis):
    """The rank's coordinate on `axis` (`lax.axis_index`)."""
    return grid.coords[rank][axis]


_SUBGROUPS = {}


def process_group_of(procs):
    """The `torch.distributed` group over the processes `procs` (sorted
    process ranks): None for the whole world, else a group made once and
    kept (`new_group` with local synchronization: only members call it)."""
    procs = tuple(sorted(int(p) for p in procs))
    if procs == tuple(range(dist.get_world_size())):
        return None
    if procs not in _SUBGROUPS:
        _SUBGROUPS[procs] = dist.new_group(list(procs),
                                           use_local_synchronization=True)
    return _SUBGROUPS[procs]


def _dc():
    """`distributed.collective` (imported late: it imports this module),
    whose `_world_gather` / `_world_reduce` move values between
    processes."""
    from ..distributed import collective
    return collective


class _ProcGather(torch.autograd.Function):
    """The processes' stacks of `pg`, in process order (all_gather),
    whose backward all-reduces (SUM) the cotangent of the whole stack
    over the processes and hands back the local rows (all_gather's
    transpose)."""

    @staticmethod
    def forward(ctx, pg, local):
        ctx.pg = pg
        ctx.me = dist.get_rank(pg) if pg is not None else dist.get_rank()
        return torch.stack(_dc()._world_gather(local, pg))

    @staticmethod
    def backward(ctx, g):
        dc = _dc()
        return None, dc._world_reduce(g, dc.ReduceOp.SUM, ctx.pg)[ctx.me]


def _gather_members(pg, locals_):
    """Every process's list of local member values (same shapes and
    dtypes in every process), in process order: differentiable for
    floating values."""
    local = torch.stack([x.to(locals_[0].device) for x in locals_])
    if local.is_floating_point() and torch.is_grad_enabled() and \
            any(x.requires_grad for x in locals_):
        full = _ProcGather.apply(pg, local)
    else:
        full = torch.stack(_dc()._world_gather(local, pg))
    return [list(part.unbind(0)) for part in full.unbind(0)]


class RankGrid:
    """Ranks over the mesh axes, each with its device.

    dims: {axis: size} over `axes` (default `AXES`; an axis left out has
    size 1); devices: one torch.device a rank (None for a rank another
    process drives). The ranks split into `nproc` blocks of device slots,
    one a process; a rank's slot is its row-major index over `order` (the
    axes slowest first; default `axes`, so the blocks are consecutive
    ranks, and axes left out of `order` follow it in `axes` order). This
    process (`proc`) drives `local_ranks`, in slot order."""

    def __init__(self, dims, devices, axes=AXES, nproc=1, proc=0,
                 order=None):
        self.axes = tuple(axes)
        unknown = set(dims) - set(self.axes)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not among "
                             f"{self.axes}")
        self.dims = {a: int(dims.get(a, 1)) for a in self.axes}
        self.shape = tuple(self.dims[a] for a in self.axes)
        self.size = math.prod(self.shape)
        if len(devices) != self.size:
            raise ValueError(f"{len(devices)} devices for {self.size} ranks")
        self.devices = list(devices)
        self.coords = [dict(zip(self.axes, (int(i) for i in
                                            np.unravel_index(r, self.shape))))
                       for r in range(self.size)]
        if self.size % nproc:
            raise ValueError(f"{self.size} ranks do not split over {nproc} "
                             "processes")
        order = tuple(order or ())
        if set(order) - set(self.axes) or len(set(order)) != len(order):
            raise ValueError(f"order {order} is not a list of distinct axes "
                             f"of {self.axes}")
        self.order = order + tuple(a for a in self.axes if a not in order)
        self.slots = [self.flat_index(r, self.order)
                      for r in range(self.size)]
        self.nproc, self.proc = nproc, proc
        self.per_proc = self.size // nproc
        self.local_ranks = sorted(
            (r for r in range(self.size) if self.process_of(r) == proc),
            key=self.slots.__getitem__)

    def process_of(self, rank):
        """The process that drives `rank`."""
        return self.slots[rank] // self.per_proc

    def ranks_where(self, **coords):
        """Rank ids whose coordinates equal `coords`, in rank order."""
        return [r for r in range(self.size)
                if all(self.coords[r][a] == v for a, v in coords.items())]

    def flat_index(self, rank, axes):
        """The rank's row-major index over `axes` (in the order given)."""
        idx = 0
        for a in axes:
            idx = idx * self.dims[a] + self.coords[rank][a]
        return idx

    def groups(self, ranks, axes):
        """Positions into `ranks`, grouped by every coordinate outside
        `axes`; each group holds the whole of `axes`, in rank order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        want = math.prod(self.dims[a] for a in axes)
        buckets = {}
        for pos, r in enumerate(ranks):
            key = tuple(self.coords[r][a] for a in self.axes
                        if a not in axes)
            buckets.setdefault(key, []).append(pos)
        out = []
        for g in buckets.values():
            g.sort(key=lambda p: ranks[p])
            if len(g) != want:
                raise ValueError(f"ranks {ranks} do not hold whole groups "
                                 f"over {axes}")
            out.append(g)
        return out

    def over(self, ranks, axes, fn, xs):
        """Apply the group collective `fn` to each group of `axes` among
        `ranks` (xs: one value a rank of `ranks`; a value may be a tuple,
        which `fn` receives whole). Under processes, a group whose other
        members are remote ranks gathers them (see the module
        docstring)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if all(self.dims[a] == 1 for a in axes):
            return list(xs)
        out = [None] * len(xs)
        if self.nproc == 1:
            for g in self.groups(ranks, axes):
                for pos, y in zip(g, fn([xs[p] for p in g])):
                    out[pos] = y
            return out
        pos_of = {r: i for i, r in enumerate(ranks)}
        mine = set(self.local_ranks)
        spanning = {}                # process set -> [group], rank order
        for g in self.whole_groups(ranks, axes):
            if all(r in pos_of for r in g):
                for r, y in zip(g, fn([xs[pos_of[r]] for r in g])):
                    out[pos_of[r]] = y
                continue
            if not all(r in pos_of or r not in mine for r in g):
                raise ValueError(f"ranks {ranks} hold part of this "
                                 f"process's group {g}")
            procs = tuple(sorted({self.process_of(r) for r in g}))
            spanning.setdefault(procs, []).append(g)
        # every process takes its process sets, and the groups in each,
        # in one global order, so their gathers meet
        for procs in sorted(spanning):
            self._over_spanning(procs, sorted(spanning[procs]), pos_of, fn,
                                xs, out)
        return out

    def whole_groups(self, ranks, axes):
        """The groups of `axes` that the ranks of `ranks` belong to: each
        the whole group of global ranks, in rank order, in the order of
        the first rank of `ranks` each holds."""
        seen, out = set(), []
        for r in ranks:
            key = tuple(self.coords[r][a] for a in self.axes
                        if a not in axes)
            if key in seen:
                continue
            seen.add(key)
            fixed = {a: self.coords[r][a] for a in self.axes
                     if a not in axes}
            out.append(self.ranks_where(**fixed))
        return out

    def _over_spanning(self, procs, groups, pos_of, fn, xs, out):
        """`fn` over groups whose members lie in the processes `procs`:
        one gather of the local members of all of them (one per tuple
        component), then each group in full, keeping the local outputs."""
        members = [r for g in groups for r in g
                   if self.process_of(r) == self.proc]
        per_proc = {p: [r for g in groups for r in g
                        if self.process_of(r) == p] for p in procs}
        if len({len(v) for v in per_proc.values()}) != 1:
            raise ValueError(f"groups {groups} hold unequal numbers of "
                             f"ranks in processes {procs}")
        pg = process_group_of(procs)
        local_vals = [xs[pos_of[r]] for r in members]
        tup = isinstance(local_vals[0], (tuple, list))
        comps = list(zip(*local_vals)) if tup else [local_vals]
        value = {}
        for c, vals in enumerate(comps):
            got = _gather_members(pg, list(vals))
            for p, part in zip(procs, got):
                for r, v in zip(per_proc[p], part):
                    value.setdefault(r, [None] * len(comps))[c] = v
        for r in members:           # a local member keeps its own value
            value[r] = list(local_vals[members.index(r)]) if tup \
                else [local_vals[members.index(r)]]
        for g in groups:
            res = fn([tuple(value[r]) if tup else value[r][0] for r in g])
            for r, y in zip(g, res):
                if r in pos_of:
                    out[pos_of[r]] = y
