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
so the axis named first is the one whose groups span the processes. For a
group of `over` whose members lie in other processes:
  * a reduction (`psum`, `pmean`, `axis_psum`, `mp_copy`, and
    `functools.partial(psum_scatter, dim=d)` without autograd) adds each
    process's members in f32 in rank order and runs one
    `torch.distributed` all-reduce (reduce-scatter) of those partial sums
    over the processes, as XLA lowers a psum: (n - 1)/n of the value's
    bytes a process for a reduce-scatter. With one member a process
    among two processes this is one controller's sum bit for bit;
    elsewhere the order of the sum differs (within 1e-6 of the largest
    magnitude in f32, per step, in the tests);
  * anything else gathers the members through a `torch.distributed`
    group of those processes (`_ProcGather`), runs the group collective
    on the whole group in every member process and keeps its own
    members' outputs: one controller's result, at (members - 1) x the
    value's bytes a group. The gather's backward sums the processes'
    cotangents of each member and hands them to its owner.
`shift_over` and `all_to_all_over` give a rank that holds only its own
value a `ppermute` (send / recv) and an `all_to_all` (one
`torch.distributed.all_to_all`) over a group spanning processes.

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
import functools
import math

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AXES", "RankGrid", "psum", "pmean", "pmax", "all_gather",
           "psum_scatter", "ppermute", "all_to_all", "axis_psum", "mp_copy",
           "axis_index", "shift_over", "all_to_all_over"]

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


def _reduction(fn, xs):
    """The kind of reduction `fn` is, for `RankGrid.over` to run across
    processes as a collective of partial sums: ("sum",), ("mean",),
    ("axis_psum",), ("mp_copy",) or ("scatter", dim); None for anything
    else (and for a differentiable reduce-scatter, or values that are not
    floating tensors), which gathers the members instead."""
    if not xs or not all(isinstance(x, torch.Tensor) and
                         x.is_floating_point() for x in xs):
        return None
    if fn is psum:
        return ("sum",)
    if fn is pmean:
        return ("mean",)
    if fn is axis_psum:
        return ("axis_psum",)
    if fn is mp_copy:
        return ("mp_copy",)
    if isinstance(fn, functools.partial) and fn.func is psum_scatter and \
            not fn.args and set(fn.keywords) == {"dim"}:
        if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
            return None
        return ("scatter", fn.keywords["dim"])
    return None


def _allreduce_partials(pg, counts, vals, scale):
    """Each group's sum over every process: `vals` holds this process's
    members, `counts[i]` of them for group i (rank order); their f32
    partial sums travel as one flat all-reduce. One f32 tensor a group,
    on its first member's device, times `scale[i]`."""
    parts, i = [], 0
    for c in counts:
        parts.append(_sum_f32(vals[i:i + c], vals[i].device))
        i += c
    dc = _dc()
    flat = torch.cat([p.reshape(-1) for p in parts])
    got = dc._comm(flat)
    dist.all_reduce(got, dist.ReduceOp.SUM, group=pg)
    got = got.to(vals[0].device)
    out, off = [], 0
    for p, k in zip(parts, scale):
        n = p.numel()
        g = got[off:off + n].view(p.shape).to(p.device)
        out.append(g if k == 1 else g / k)
        off += n
    return out


def _spread_groups(sums, counts, like):
    """Each group's sum handed to its members (their dtype and device),
    in the order of `like`."""
    out, i = [], 0
    for s, c in zip(sums, counts):
        out.extend(_spread(s, like[i:i + c]))
        i += c
    return out


class _ProcReduce(torch.autograd.Function):
    """psum / pmean / axis_psum / mp_copy over groups spanning processes,
    as local partial sums and one all-reduce. Backward: psum's and
    pmean's transpose is the same reduction of the cotangents,
    axis_psum's the identity, mp_copy's a psum."""

    @staticmethod
    def forward(ctx, meta, *vals):
        pg, counts, sizes, kind = meta
        ctx.meta = meta
        if kind == "mp_copy":
            return tuple(v.view_as(v) for v in vals)
        scale = sizes if kind == "mean" else [1] * len(sizes)
        return tuple(_spread_groups(
            _allreduce_partials(pg, counts, vals, scale), counts, vals))

    @staticmethod
    def backward(ctx, *gs):
        pg, counts, sizes, kind = ctx.meta
        if kind == "axis_psum":
            return (None,) + gs
        scale = sizes if kind == "mean" else [1] * len(sizes)
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        return (None,) + tuple(_spread_groups(
            _allreduce_partials(pg, counts, gs, scale), counts, gs))


def _scatter_partials(grid, procs, groups, mine, pg, dim, vals):
    """psum_scatter(dim) over groups spanning processes: this process's
    f32 partial sum of each group is cut into the members' chunks, the
    chunks are laid out process by process (each process's members of
    each group, rank order), and one reduce-scatter over the processes
    hands each process its members' chunks of the sum."""
    dc = _dc()
    partial = []
    for g, vs in zip(groups, vals):
        n = len(g)
        if vs[0].shape[dim] % n:
            raise ValueError(f"psum_scatter: dim {dim} of size "
                             f"{vs[0].shape[dim]} does not split {n} ways")
        partial.append(_sum_f32(vs, vs[0].device).chunk(n, dim))
    order = []                       # (process, group, position) blocks
    for p in procs:
        for gi, g in enumerate(groups):
            for i, r in enumerate(g):
                if grid.process_of(r) == p:
                    order.append((p, gi, i))
    flat = dc._comm(torch.cat([partial[gi][i].reshape(-1)
                               for _, gi, i in order]))
    got = torch.empty(flat.numel() // len(procs), dtype=torch.float32,
                      device=flat.device)
    dist.reduce_scatter_tensor(got, flat, dist.ReduceOp.SUM, group=pg)
    out, off = [], 0
    for gi, loc in enumerate(mine):
        for r in loc:
            i = groups[gi].index(r)
            c = partial[gi][i]
            x = vals[gi][loc.index(r)]
            out.append(got[off:off + c.numel()].view(c.shape)
                       .to(x.device, x.dtype))
            off += c.numel()
    return out


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
        members are remote ranks runs a reduction as partial sums and
        one collective, anything else by gathering them (see the module
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
        # in one global order, so their collectives meet
        kind = _reduction(fn, xs)
        for procs in sorted(spanning):
            if kind is None:
                self._over_spanning(procs, sorted(spanning[procs]), pos_of,
                                    fn, xs, out)
            else:
                self._reduce_spanning(procs, sorted(spanning[procs]), pos_of,
                                      kind, xs, out)
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

    def _reduce_spanning(self, procs, groups, pos_of, kind, xs, out):
        """A reduction over groups whose members lie in the processes
        `procs`: each process sums its members of each group (f32, rank
        order), and one `torch.distributed` all-reduce (reduce-scatter for
        `psum_scatter`) of those partial sums runs over the processes."""
        mine = [[r for r in g if self.process_of(r) == self.proc]
                for g in groups]
        pg = process_group_of(procs)
        vals = [xs[pos_of[r]] for loc in mine for r in loc]
        if kind[0] == "scatter":
            res = _scatter_partials(self, procs, groups, mine, pg, kind[1],
                                    [[xs[pos_of[r]] for r in loc]
                                     for loc in mine])
        else:
            sizes = [len(g) for g in groups]
            res = _ProcReduce.apply(
                (pg, [len(loc) for loc in mine], sizes, kind[0]), *vals)
        for r, y in zip((r for loc in mine for r in loc), res):
            out[pos_of[r]] = y

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


# ---------------------------------------------------------------------------
# One value a local rank, its group's other members in other processes
# ---------------------------------------------------------------------------

def _wire(t):
    """`t` as gloo / NCCL take it: contiguous, on the host under gloo,
    bf16 and f16 widened to f32 for gloo (exact)."""
    t = _dc()._comm(t)
    if dist.get_backend() == "gloo" and t.dtype in (torch.bfloat16,
                                                   torch.float16):
        t = t.float()
    return t


def _p2p(sends, recvs):
    """Post every send (process, tag, tensor) and receive (process, tag,
    tensor like the one expected) at once, then wait for all of them.
    Returns the received tensors, each in the dtype and on the device of
    its template."""
    reqs, keep, bufs = [], [], []
    for proc, tag, t in sends:
        w = _wire(t)
        keep.append(w)
        reqs.append(dist.isend(w, proc, tag=tag))
    for proc, tag, like in recvs:
        on = _wire(like.reshape(-1)[:0])      # the wire's dtype and device
        w = torch.empty(like.shape, dtype=on.dtype, device=on.device)
        bufs.append(w)
        reqs.append(dist.irecv(w, proc, tag=tag))
    for q in reqs:
        q.wait()
    return [b.to(like.device, like.dtype)
            for b, (_, _, like) in zip(bufs, recvs)]


def _peer(grid, r, axis, j):
    """The rank at index `j` of `r`'s group over `axis`."""
    c = dict(grid.coords[r])
    c[axis] = j % grid.dims[axis]
    return grid.ranks_where(**c)[0]


def _shift_values(grid, ranks, axis, shift, vals):
    n = grid.dims[axis]
    pos_of = {r: i for i, r in enumerate(ranks)}
    out = [None] * len(ranks)
    sends, recvs, into = [], [], []
    for p, r in enumerate(ranks):
        i = grid.coords[r][axis]
        dst, src = _peer(grid, r, axis, i + shift), \
            _peer(grid, r, axis, i - shift)
        if dst in pos_of:
            out[pos_of[dst]] = vals[p].to(grid.devices[dst], copy=True)
        else:
            sends.append((grid.process_of(dst), r * grid.size + dst,
                          vals[p]))
        if src not in pos_of:
            recvs.append((grid.process_of(src), src * grid.size + r,
                          vals[p]))
            into.append(p)
    for p, v in zip(into, _p2p(sends, recvs)):
        out[p] = v
    return out


class _Shift(torch.autograd.Function):
    """ppermute over processes: forward by `shift`, backward by -shift."""

    @staticmethod
    def forward(ctx, meta, *vals):
        ctx.meta = meta
        grid, ranks, axis, shift = meta
        return tuple(_shift_values(grid, ranks, axis, shift, vals))

    @staticmethod
    def backward(ctx, *gs):
        grid, ranks, axis, shift = ctx.meta
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        return (None,) + tuple(_shift_values(grid, ranks, axis, -shift, gs))


def shift_over(grid, ranks, axis, xs, shift=1):
    """`ppermute` over `axis` for the ranks this process drives (`ranks`,
    one value each, all of one shape): the value of the rank at index i
    moves to index (i + shift) mod n of its group, by a copy within the
    process and by `torch.distributed` send / recv across processes.
    Differentiable (the backward shifts the cotangents back)."""
    if grid.dims[axis] == 1:
        return list(xs)
    return list(_Shift.apply((grid, tuple(ranks), axis, shift), *xs))


def _a2a_values(grid, ranks, axis, vals, split_dim, concat_dim):
    n = grid.dims[axis]
    pos_of = {r: i for i, r in enumerate(ranks)}
    groups = sorted({tuple(_peer(grid, r, axis, j) for j in range(n))
                     for r in ranks})
    procs = sorted({grid.process_of(r) for g in groups for r in g})
    for g in groups:
        if any(grid.process_of(r) == grid.proc and r not in pos_of
               for r in g):
            raise ValueError(f"ranks {list(ranks)} hold part of this "
                             f"process's group {list(g)}")
    parts = [v.chunk(n, split_dim) for v in vals]
    like = parts[0][0]

    def members(g, p):
        return [r for r in g if grid.process_of(r) == p]
    send, recv_sizes = [], []
    for q in procs:
        pieces = [parts[pos_of[s]][g.index(d)].reshape(-1)
                  for g in groups for s in members(g, grid.proc)
                  for d in members(g, q)]
        send.append(_wire(torch.cat(pieces)) if pieces else
                    _wire(like.reshape(-1)[:0]))
        recv_sizes.append(sum(len(members(g, q)) *
                              len(members(g, grid.proc))
                              for g in groups) * like.numel())
    got = [torch.empty(k, dtype=send[0].dtype, device=send[0].device)
           for k in recv_sizes]
    pg = process_group_of(procs)
    if dist.get_backend(pg) == "gloo":
        # gloo has no all_to_all in every release: the same exchange as
        # one send and one receive with each other process
        me = procs.index(grid.proc)
        got[me] = send[me]
        others = [i for i in range(len(procs)) if i != me]
        tag = 1 << 30              # apart from every point-to-point tag
        for i, v in zip(others, _p2p(
                [(procs[i], tag + grid.proc, send[i]) for i in others],
                [(procs[i], tag + procs[i], got[i]) for i in others])):
            got[i] = v
    else:
        dist.all_to_all(got, send, group=pg)
    chunk = {}                       # (source, destination) -> chunk
    for q, buf in zip(procs, got):
        off = 0
        for g in groups:
            for s in members(g, q):
                for d in members(g, grid.proc):
                    chunk[s, d] = buf[off:off + like.numel()].view(
                        like.shape)
                    off += like.numel()
    out = [None] * len(ranks)
    for g in groups:
        for d in members(g, grid.proc):
            x = vals[pos_of[d]]
            out[pos_of[d]] = torch.cat(
                [chunk[s, d].to(x.device, x.dtype) for s in g], concat_dim)
    return out


class _AllToAll(torch.autograd.Function):
    """all_to_all over processes; its transpose swaps the two dims."""

    @staticmethod
    def forward(ctx, meta, *vals):
        ctx.meta = meta
        grid, ranks, axis, a, b = meta
        return tuple(_a2a_values(grid, ranks, axis, vals, a, b))

    @staticmethod
    def backward(ctx, *gs):
        grid, ranks, axis, a, b = ctx.meta
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        return (None,) + tuple(_a2a_values(grid, ranks, axis, gs, b, a))


def all_to_all_over(grid, ranks, axis, xs, split_dim, concat_dim):
    """`all_to_all` over `axis` for the ranks this process drives (one
    value each, all of one shape; the groups of `ranks` hold every one of
    their local members): the chunks bound for each process ride one
    `torch.distributed.all_to_all` over the processes the groups span
    (under gloo, one send and one receive with each other process).
    Differentiable (the backward is the reverse exchange)."""
    n = grid.dims[axis]
    if n == 1:
        return list(xs)
    if xs[0].shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{xs[0].shape[split_dim]} does not split {n} ways")
    return list(_AllToAll.apply((grid, tuple(ranks), axis, split_dim,
                                 concat_dim), *xs))
