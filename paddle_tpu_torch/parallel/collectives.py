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


class RankGrid:
    """Ranks over the mesh axes, each with its device.

    dims: {axis: size} over `axes` (default `AXES`; an axis left out has
    size 1); devices: one torch.device a rank (None for a rank another
    process drives). The ranks split into `nproc` consecutive blocks, one
    a process; this process (`proc`) drives `local_ranks`."""

    def __init__(self, dims, devices, axes=AXES, nproc=1, proc=0):
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
        self.nproc, self.proc = nproc, proc
        self.per_proc = self.size // nproc
        self.local_ranks = list(range(proc * self.per_proc,
                                      (proc + 1) * self.per_proc))

    def process_of(self, rank):
        """The process that drives `rank`."""
        return rank // self.per_proc

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
        `ranks` (xs: one value a rank of `ranks`)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if all(self.dims[a] == 1 for a in axes):
            return list(xs)
        out = [None] * len(xs)
        for g in self.groups(ranks, axes):
            for pos, y in zip(g, fn([xs[p] for p in g])):
                out[pos] = y
        return out
